"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Whether a card is present is decided inside the ``cuda`` fixture, never
at import, so every pytest worker collects the same tests; without a
card each test skips with that reason.  Tolerance rtol = atol = 1e-5 for
the f32 aggregation; the QSGD quantize, dequantize and chain-apply kernels
must give the same bits as their plain versions.
"""
import pytest
import torch

from repro_torch.kernels import broadcast as bc
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import tree_aggregate as ta

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "G,C,L",
    [(3, 5, 333), (1, 1, 1), (4, 1, 1029), (1, 7, 4097), (9, 3, 6792),
     (1, 12, 6792), (8, 3, 8848), (1, 16, 131072), (70000, 2, 5)],
)
def test_kernel_matches_plain_version(cuda, G, C, L, dtype):
    gen = torch.Generator(device=cuda).manual_seed(G * C + L)
    x = torch.randn(G, C, L, device=cuda, generator=gen).to(dtype)
    w = torch.rand(G, C, device=cuda, generator=gen)
    if C > 1:  # ragged last slot: zero row, zero weight
        x[:, -1] = 0
        w[:, -1] = 0
    before = ta.launches
    out = ta.tree_aggregate_groups(x, w)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (G, L)
    torch.testing.assert_close(out, ref.tree_aggregate_groups_ref(x, w), **TOL)


def test_misaligned_rows_take_the_scalar_path(cuda):
    base = torch.randn(2 * 3 * 1001 + 1, device=cuda)
    x = base[1:].view(2, 3, 1001)  # 4-byte offset: no 16-byte loads
    w = torch.rand(2, 3, device=cuda)
    torch.testing.assert_close(
        ta.tree_aggregate_groups(x, w), ref.tree_aggregate_groups_ref(x, w), **TOL
    )


def test_g1_wrapper_and_buffered_aggregate_on_card(cuda):
    x = torch.randn(16, 2048, device=cuda)
    w = torch.rand(16, device=cuda)
    torch.testing.assert_close(ops.tree_aggregate(x, w), ref.tree_aggregate_ref(x, w), **TOL)
    ups = [{"a": torch.randn(7, 3, device=cuda)} for _ in range(4)]
    agg, comb = ops.buffered_aggregate(ups, [1.0, 2.0, 3.0, 4.0], [0, 1, 2, 3], alpha=0.5)
    cpu, _ = ops.buffered_aggregate([{"a": u["a"].cpu()} for u in ups],
                                    [1.0, 2.0, 3.0, 4.0], [0, 1, 2, 3], alpha=0.5)
    torch.testing.assert_close(agg["a"].cpu(), cpu["a"], **TOL)


def test_wrapper_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        ta.tree_aggregate_groups(torch.zeros(1, 2, 3, device=cuda), torch.zeros(1, 2))


# -- QSGD quantize / dequantize, chain apply, int8 aggregation ------------------

ROWS = [1, 27, 4096, 100_000]  # 100k rows of 256: past one wave of the grid


def _rows(R, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(R, 256, device=device, generator=gen)
    x *= torch.rand(R, 1, device=device, generator=gen) * 10 + 1e-4
    u = torch.rand(R, 256, device=device, generator=gen)
    x[0] = torch.linspace(-0.1, 0.1, 256, device=device)
    x[0, 0] = 0.16625983  # floor(x/scale + u) reaches 128 at levels 127
    u[0, 0] = 1.0 - 2.0**-24
    if R > 1:
        x[-1] = 0.0
    return x, u


@pytest.mark.parametrize("levels", [127, 7, 3])
@pytest.mark.parametrize("R", ROWS)
def test_quantize_kernel_bit_equal_to_plain_version(cuda, R, levels):
    x, u = _rows(R, cuda, seed=R + levels)
    before = qz.launches["qsgd_quantize"]
    q, s = qz.qsgd_quantize(x, u, levels=levels)
    torch.cuda.synchronize()
    assert qz.launches["qsgd_quantize"] == before + 1
    rq, rs = ref.quantize_ref(x, u, levels=levels)
    assert torch.equal(s, rs) and torch.equal(q, rq)
    if levels == 127:
        assert int(q[0, 0]) == 127


@pytest.mark.parametrize("R", ROWS)
def test_dequantize_kernel_bit_equal_to_plain_version(cuda, R):
    gen = torch.Generator(device=cuda).manual_seed(R)
    q = torch.randint(-128, 128, (R, 256), device=cuda, generator=gen, dtype=torch.int8)
    s = torch.rand(R, 1, device=cuda, generator=gen) * 0.1
    before = qz.launches["qsgd_dequantize"]
    out = qz.qsgd_dequantize(q, s)
    torch.cuda.synchronize()
    assert qz.launches["qsgd_dequantize"] == before + 1
    assert torch.equal(out, ref.dequantize_ref(q, s))


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("R", ROWS)
def test_chain_apply_kernel_bit_equal_and_chain_order(cuda, R, D):
    gen = torch.Generator(device=cuda).manual_seed(R * D)
    w = torch.randn(R, 256, device=cuda, generator=gen)
    q = torch.randint(-127, 128, (D, R, 256), device=cuda, generator=gen, dtype=torch.int8)
    s = torch.rand(D, R, 1, device=cuda, generator=gen) * 0.05
    before = bc.launches
    out = bc.apply_quantized_broadcast(w, q, s)
    torch.cuda.synchronize()
    assert bc.launches == before + 1
    assert torch.equal(out, ref.apply_quantized_ref(w, q, s))
    step = w
    for d in range(D):
        step = bc.apply_quantized_broadcast(step, q[d : d + 1], s[d : d + 1])
    assert torch.equal(out, step)


def test_new_kernels_on_misaligned_views(cuda):
    R = 27
    xb, ub = torch.randn(R * 256 + 1, device=cuda), torch.rand(R * 256 + 1, device=cuda)
    x, u = xb[1:].view(R, 256), ub[1:].view(R, 256)  # 4-byte offset
    q, s = qz.qsgd_quantize(x, u, levels=7)
    rq, rs = ref.quantize_ref(x, u, levels=7)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    qb = torch.randint(-127, 128, (3 * R * 256 + 3,), device=cuda, dtype=torch.int8)
    qv = qb[3:].view(3, R, 256)  # 3-byte offset
    sv = torch.rand(3 * R + 1, device=cuda)[1:].view(3, R, 1)
    assert torch.equal(qz.qsgd_dequantize(qv[0], sv[0]), ref.dequantize_ref(qv[0], sv[0]))
    assert torch.equal(bc.apply_quantized_broadcast(x, qv, sv), ref.apply_quantized_ref(x, qv, sv))
    gb = torch.randint(-128, 128, (R * 4 * 256 + 1,), device=cuda, dtype=torch.int8)
    g = gb[1:].view(R, 4, 256)  # 1-byte offset: the int8 aggregation's scalar path
    w = torch.rand(R, 4, device=cuda) * 1e-2
    assert torch.equal(ta.tree_aggregate_groups(g, w), ta.tree_aggregate_groups(g.float(), w))


@pytest.mark.parametrize("G,C,L", [(27, 4, 256), (1, 1, 1), (4096, 4, 256), (3, 5, 333), (1, 16, 131072)])
def test_int8_aggregate_equals_f32_path(cuda, G, C, L):
    gen = torch.Generator(device=cuda).manual_seed(G + C + L)
    q = torch.randint(-128, 128, (G, C, L), device=cuda, generator=gen, dtype=torch.int8)
    w = torch.rand(G, C, device=cuda, generator=gen) * 1e-2
    before = ta.launches
    out = ta.tree_aggregate_groups(q, w)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    assert torch.equal(out, ta.tree_aggregate_groups(q.float(), w))
    torch.testing.assert_close(out, ref.tree_aggregate_groups_ref(q, w), **TOL)


def test_compressed_apply_on_card_matches_cpu(cuda):
    qs = [torch.randint(-127, 128, (27, 256), dtype=torch.int8) for _ in range(4)]
    ss = [torch.rand(27, 1) * 0.05 for _ in range(4)]
    args = ([1.0, 2.0, 3.0, 4.0], [0, 1, 2, 0])
    cpu, _ = ops.buffered_aggregate_quantized(qs, ss, *args, alpha=0.5)
    gpu, _ = ops.buffered_aggregate_quantized(
        [q.to(cuda) for q in qs], [s.to(cuda) for s in ss], *args, alpha=0.5)
    torch.testing.assert_close(gpu.cpu(), cpu, **TOL)
