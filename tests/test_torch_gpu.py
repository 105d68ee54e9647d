"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Whether a card is present is decided inside the ``cuda`` fixture, never
at import, so every pytest worker collects the same tests; without a
card each test skips with that reason.  The aggregation gives the bits
of ``ref.tree_aggregate_groups_chain`` (its fmaf chain) and lies within
rtol = atol = 1e-5 of ``tree_aggregate_groups_ref``; the QSGD quantize
(with and without the EF residual), dequantize, chain-apply, fused update
and policy update kernels must give the same bits as their plain versions
(the policy update also the same rho and pi~ on every node), on their
vector and scalar paths.
"""
import pytest
import torch

from repro_torch.kernels import broadcast as bc
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import ops, ref
from repro_torch.kernels import policy_update as pu
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
    assert torch.equal(out, ref.tree_aggregate_groups_chain(x, w))
    torch.testing.assert_close(out, ref.tree_aggregate_groups_ref(x, w), **TOL)


def _level(G, C, L, dtype, device, seed, ragged=True):
    """(G, C, L) children of ``dtype`` and (G, C) f32 weights; with
    ``ragged``, group g keeps C - (g % C) real children, the rest zero rows
    at zero weight.  int8 rows take the compressed apply's small weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int8:
        x = torch.randint(-128, 128, (G, C, L), device=device, generator=gen, dtype=torch.int8)
        w = torch.rand(G, C, device=device, generator=gen) * 1e-2
    else:
        x = torch.randn(G, C, L, device=device, generator=gen).to(dtype)
        w = torch.rand(G, C, device=device, generator=gen)
    if ragged and C > 1:
        for g in range(min(G, C)):
            x[g::C, C - g:] = 0
            w[g::C, C - g:] = 0
    return x, w


def _check_level(x, w):
    before = ta.launches
    out = ta.tree_aggregate_groups(x, w)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], x.shape[2])
    assert torch.equal(out, ref.tree_aggregate_groups_chain(x, w))
    torch.testing.assert_close(out, ref.tree_aggregate_groups_ref(x, w), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("children", ["tile-1", "tile", "tile+1", "2*tile+3", "64"])
def test_kernel_bit_equal_to_chain_at_child_tile_edges(cuda, children, G, dtype):
    """C around the kernel's child tile: the tail tile's masked loads and the
    chain across tiles keep the c-ordered fmaf chain bit for bit."""
    tile = ta.child_tile()
    C = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "2*tile+3": 2 * tile + 3,
         "64": 64}[children]
    _check_level(*_level(G, max(C, 1), 4096, dtype, cuda, seed=G * 100 + C))


MAIN_PATH_LEVELS = [
    # the quickstart MLP's sync levels (L = 6792), the CNN app's (L = 8848),
    # the async apply (K = 4 commits), the compressed apply's int8 level
    (3, 3, 6792, torch.float32), (7, 1, 6792, torch.float32), (9, 3, 6792, torch.float32),
    (1, 12, 6792, torch.float32), (6, 1, 6792, torch.float32), (5, 1, 8848, torch.float32),
    (7, 2, 8848, torch.float32), (8, 3, 8848, torch.float32), (1, 11, 8848, torch.float32),
    (1, 4, 6792, torch.float32), (1, 16, 131072, torch.bfloat16), (1, 16, 131072, torch.float32),
    (27, 4, 256, torch.int8), (27, 3, 256, torch.int8),
    (29, 3, 256, torch.int8),  # 16-lane rows packed: a ragged last block
    (5, 4, 333, torch.int8),   # L % 16 != 0: the scalar path
    (4096, 4, 256, torch.int8),
]


@pytest.mark.parametrize("G,C,L,dtype", MAIN_PATH_LEVELS)
def test_kernel_bit_equal_to_chain_at_main_path_levels(cuda, G, C, L, dtype):
    _check_level(*_level(G, C, L, dtype, cuda, seed=G + C + L))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("G,C,L", [(2, 3, 1001), (3, 4, 256), (1, 12, 6792)])
def test_misaligned_views_bit_equal_to_chain(cuda, G, C, L, dtype):
    """A base one element past a 16-byte boundary takes the scalar path."""
    x, w = _level(G, C, L + 1, dtype, cuda, seed=L)
    view = x.reshape(-1)[1 : 1 + G * C * L].view(G, C, L)
    assert view.data_ptr() % 16 != 0
    _check_level(view, w)


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


@pytest.mark.parametrize("levels", [127, 7, 3])
@pytest.mark.parametrize("R", [1, 2, 3, 7, 8, 9, 27, 4096, 70001])
def test_quantize_row_blocks_bit_equal_on_views(cuda, R, levels):
    """Row counts around the kernel's rows per block (ragged last blocks),
    with the row that saturates at 128 and the zero row, on the tensors as
    allocated and on views one element (the scalar path) and four elements
    (16-byte aligned, offset) into a larger buffer."""
    x, u = _rows(R, cuda, seed=7 * R + levels)
    rq, rs = ref.quantize_ref(x, u, levels=levels)
    for shift in (0, 1, 4):
        xb = torch.empty(R * 256 + shift, device=cuda)
        ub = torch.empty(R * 256 + shift, device=cuda)
        xv, uv = xb[shift:].view(R, 256), ub[shift:].view(R, 256)
        xv.copy_(x)
        uv.copy_(u)
        before = qz.launches["qsgd_quantize"]
        q, s = qz.qsgd_quantize(xv, uv, levels=levels)
        torch.cuda.synchronize()
        assert qz.launches["qsgd_quantize"] == before + 1
        assert torch.equal(s, rs) and torch.equal(q, rq), f"shift {shift}"
    if levels == 127:
        assert int(q[0, 0]) == 127
    if R > 1:  # the zero row: the 1e-12 floor, all-zero lattice points
        assert not q[-1].any()


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


@pytest.mark.parametrize("levels", [127, 7, 3])
@pytest.mark.parametrize("R", [1, 2, 27, 4096, 70001])
def test_quantize_residual_instance_bit_equal_on_views(cuda, R, levels):
    """The residual instance against ``ref.quantize_residual_ref`` (the
    row that saturates at 127, the zero row), on views 0, 1 (the scalar
    path) and 4 elements into a buffer; its q and s are the no-residual
    instance's; each call counts one quantize launch, of the residual
    instance."""
    x, u = _rows(R, cuda, seed=11 * R + levels)
    rq, rs, rr = ref.quantize_residual_ref(x, u, levels=levels)
    for shift in (0, 1, 4):
        xb, ub = torch.empty(R * 256 + shift, device=cuda), torch.empty(R * 256 + shift, device=cuda)
        xv, uv = xb[shift:].view(R, 256), ub[shift:].view(R, 256)
        xv.copy_(x)
        uv.copy_(u)
        before = dict(qz.launches)
        q, s, r = qz.qsgd_quantize_residual(xv, uv, levels=levels)
        torch.cuda.synchronize()
        assert qz.launches == {**before, "qsgd_quantize": before["qsgd_quantize"] + 1,
                               "qsgd_quantize_residual": before["qsgd_quantize_residual"] + 1}
        assert torch.equal(q, rq) and torch.equal(s, rs) and torch.equal(r, rr), f"shift {shift}"
        q2, s2 = qz.qsgd_quantize(xv, uv, levels=levels)
        assert torch.equal(q2, q) and torch.equal(s2, s)
    if levels == 127:
        assert int(q[0, 0]) == 127
    if R > 1:
        assert not q[-1].any() and not r[-1].any()


@pytest.mark.parametrize("shift", [0, 1, 8])
@pytest.mark.parametrize("C", [256, 8, 1000, 300, 7])
@pytest.mark.parametrize("R", [1, 27, 4096])
def test_dequantize_vector_and_scalar_paths(cuda, R, C, shift):
    """Widths that are and are not whole 8-byte vectors, on q views 0, 1
    (scalar path) and 8 bytes into a buffer."""
    gen = torch.Generator(device=cuda).manual_seed(R + C + shift)
    qb = torch.randint(-128, 128, (R * C + shift,), device=cuda, generator=gen, dtype=torch.int8)
    q = qb[shift:].view(R, C)
    s = torch.rand(R, 1, device=cuda, generator=gen) * 0.1
    before = qz.launches["qsgd_dequantize"]
    out = qz.qsgd_dequantize(q, s)
    torch.cuda.synchronize()
    assert qz.launches["qsgd_dequantize"] == before + 1
    assert torch.equal(out, ref.dequantize_ref(q, s))


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("R", [1, 27, 4096])
def test_chain_apply_depths_on_views(cuda, R, D, misaligned):
    """Every unrolled depth and the loop past it, bit-equal and equal to D
    single steps, on aligned tensors and on views 1 element into w and 3
    bytes into q (the scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(R * D + misaligned)
    off = (1, 3) if misaligned else (0, 0)
    w = torch.randn(R * 256 + off[0], device=cuda, generator=gen)[off[0]:].view(R, 256)
    q = torch.randint(-127, 128, (D * R * 256 + off[1],), device=cuda, generator=gen,
                      dtype=torch.int8)[off[1]:].view(D, R, 256)
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


def test_fused_ef_route_on_card_launches_no_dequantize(cuda):
    """An EF commit under qsgd-int8 at chunk 256 on the card: one quantize
    launch of the residual instance, no dequantize launch, and the CPU
    path's bits; ``dequantize_delta`` launches the dequantize once."""
    from repro_torch.fl import compression as comp

    gen = torch.Generator().manual_seed(0)
    delta = {"w": torch.randn(40, 70, generator=gen), "b": torch.randn(13, generator=gen)}
    policy = comp.CompressionPolicy(kind="qsgd-int8", error_feedback=True)
    key = (comp.COMMIT_LANE, 0, 5)
    cpu_qd, cpu_res = comp.quantize_delta_with_residual(delta, policy, key)
    before = dict(qz.launches)
    qd, res = comp.quantize_delta_with_residual({k: v.to(cuda) for k, v in delta.items()},
                                                policy, key)
    torch.cuda.synchronize()
    assert qz.launches == {"qsgd_quantize": before["qsgd_quantize"] + 1,
                           "qsgd_quantize_residual": before["qsgd_quantize_residual"] + 1,
                           "qsgd_dequantize": before["qsgd_dequantize"]}
    assert torch.equal(qd.q.cpu(), cpu_qd.q) and torch.equal(qd.scale.cpu(), cpu_qd.scale)
    for k in delta:
        assert torch.equal(res[k].cpu(), cpu_res[k])
    back = comp.dequantize_delta(qd)
    torch.cuda.synchronize()
    assert qz.launches["qsgd_dequantize"] == before["qsgd_dequantize"] + 1
    for k in delta:
        assert torch.equal(back[k].cpu(), comp.dequantize_delta(cpu_qd)[k])


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
    assert torch.equal(out, ref.tree_aggregate_groups_chain(q, w))
    torch.testing.assert_close(out, ref.tree_aggregate_groups_ref(q, w), **TOL)


def test_compressed_apply_on_card_matches_cpu(cuda):
    qs = [torch.randint(-127, 128, (27, 256), dtype=torch.int8) for _ in range(4)]
    ss = [torch.rand(27, 1) * 0.05 for _ in range(4)]
    args = ([1.0, 2.0, 3.0, 4.0], [0, 1, 2, 0])
    cpu, _ = ops.buffered_aggregate_quantized(qs, ss, *args, alpha=0.5)
    gpu, _ = ops.buffered_aggregate_quantized(
        [q.to(cuda) for q in qs], [s.to(cuda) for s in ss], *args, alpha=0.5)
    torch.testing.assert_close(gpu.cpu(), cpu, **TOL)


# -- the fused FedProx update and the Algorithm-1 policy update ------------------

LENGTHS = [1, 1000, 6792, 1 << 17, (1 << 22) + 3]  # the last: many waves, a ragged tail
HYPER = [(0.2, 0.0, 0.0), (0.2, 0.01, 0.0), (0.05, 0.1, 0.01)]


@pytest.mark.parametrize("lr,mu,wd", HYPER)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", LENGTHS)
def test_fused_update_kernel_bit_equal_to_plain_version(cuda, L, dtype, lr, mu, wd):
    gen = torch.Generator(device=cuda).manual_seed(L)
    w, g, w0 = (torch.randn(L, device=cuda, generator=gen).to(dtype) for _ in range(3))
    before = fu.launches
    out = fu.fused_update(w, g, w0, lr=lr, mu=mu, wd=wd)
    torch.cuda.synchronize()
    assert fu.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, ref.fused_update_ref(w, g, w0, lr, mu, wd))
    assert torch.equal(out.cpu(), ref.fused_update_ref(w.cpu(), g.cpu(), w0.cpu(), lr, mu, wd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_update_in_place_and_misaligned(cuda, dtype):
    L = 4099
    base = torch.randn(3, L + 1, device=cuda).to(dtype)
    w, g, w0 = base[0, 1:], base[1, 1:], base[2, :-1]  # 2- or 4-byte offsets
    want = ref.fused_update_ref(w, g, w0, 0.05, 0.1, 0.01)
    assert torch.equal(fu.fused_update(w, g, w0, lr=0.05, mu=0.1, wd=0.01), want)
    buf = torch.randn(5, 7, device=cuda).to(dtype)
    g2, w02 = torch.randn_like(buf), torch.randn_like(buf)
    want = ref.fused_update_ref(buf.reshape(-1), g2.reshape(-1), w02.reshape(-1), 0.1, 0.2, 0.0)
    out = ops.fused_update(buf, g2, w02, lr=0.1, mu=0.2, donate=True)
    torch.cuda.synchronize()
    assert out.data_ptr() == buf.data_ptr() and torch.equal(buf.reshape(-1), want)


def _policy_case(N, K, cand_kind, device, seed):
    gen = torch.Generator().manual_seed(seed)
    from repro_torch.core.pathplan import candidate_policy_set

    M = K + 9
    if cand_kind == "corners":  # permuted corners: exact ties in line 5
        cand = candidate_policy_set(K, seed=seed)
    else:
        e = -torch.log(torch.rand(M, K, generator=gen))  # Dirichlet(1, ..., 1) rows
        cand = e / e.sum(-1, keepdim=True)
    mask = torch.rand(N, K, generator=gen) < 0.75
    mask[:, 0] = True
    mask[: N // 4] = True  # full rows too
    pi = torch.rand(N, K, generator=gen) * mask
    pi[1::7] = torch.where(mask[1::7], 1e-12, 0.0)  # policies at the 1e-12 floor
    pi[1::7, 0] = 1.0
    pi = pi / pi.sum(-1, keepdim=True)
    rs = torch.rand(N, K, generator=gen) * 3 * (torch.rand(N, K, generator=gen) < 0.5) * mask
    rs[::5] = 0.0  # all-zero reward rows
    return [t.to(device).contiguous() for t in (pi, mask, cand.float(), rs.float())]


@pytest.mark.parametrize("cand_kind", ["corners", "dirichlet"])
@pytest.mark.parametrize("N,K", [(1, 8), (128, 8), (4096, 16), (70_001, 16), (300, 36), (64, 2), (50, 64)])
def test_policy_update_kernel_bit_equal_to_plain_version(cuda, N, K, cand_kind):
    pi, mask, cand, rs = _policy_case(N, K, cand_kind, cuda, seed=N + K)
    kw = dict(tau=16, alpha=0.98, beta=0.5)
    before = pu.launches
    out = pu.policy_update(pi, mask, cand, rs, **kw)
    torch.cuda.synchronize()
    assert pu.launches == before + 1
    want = ref.policy_update_ref(pi, mask, cand, rs, kw["tau"], kw["alpha"], kw["beta"])
    assert torch.equal(out, want)
    # the same (rho, pi~) on the CPU as on the card
    on_card = ref.policy_choices(pi, mask, cand, rs, 16)[1:]
    on_cpu = ref.policy_choices(*(t.cpu() for t in (pi, mask, cand, rs)), 16)[1:]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    torch.testing.assert_close(out.cpu(), ref.policy_update_ref(
        *(t.cpu() for t in (pi, mask, cand, rs)), kw["tau"], kw["alpha"], kw["beta"]), rtol=0, atol=1e-6)


def test_policy_update_kernel_on_misaligned_views(cuda):
    N, K = 33, 8
    pi, mask, cand, rs = _policy_case(N, K, "dirichlet", cuda, seed=1)
    shift = lambda t: torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)
    args = [shift(t) for t in (pi, mask, cand, rs)]
    assert all(a.storage_offset() == 1 for a in args)
    out = pu.policy_update(*args, tau=4, alpha=0.9, beta=0.5)
    assert torch.equal(out, ref.policy_update_ref(*args, 4, 0.9, 0.5))


def test_planner_episode_on_card_matches_cpu(cuda):
    from repro_torch.core import congestion, pathplan

    env = congestion.make_env(8, seed=7)
    series = []
    for dev in (cuda, "cpu"):
        planner = pathplan.GameTheoreticPlanner(128, 8, tau=16, alpha=0.98, seed=0, device=dev)
        series.append(pathplan.run_planner(planner, env, 3))
    for k in ("nash_regret", "cum_latency_ms", "mean_reward"):  # f64 sums in other orders
        torch.testing.assert_close(torch.tensor(series[0][k]), torch.tensor(series[1][k]),
                                   rtol=1e-9, atol=1e-12)


# -- the multi-leaf fused update ---------------------------------------------------

MLP_STEP = [1024, 1024, 128, 32768, 65536, 8192]  # quickstart MLP leaves x 16 workers (sorted keys)
CNN_STEP = [2304, 73728, 65536]                   # the CNN app's leaves x 16 workers
EDGE_STEP = [1, 0, 7, 4099, 0, 3, 1000, 1]         # one-element, zero-length, ragged leaves


def _table(lengths, dtypes, device, seed, misaligned=()):
    """Leaves (w, g, w0) of the given lengths and dtypes (cycled); the leaves
    at the indices in ``misaligned`` start 4 (f32) or 2 (bf16) bytes past a
    16-byte boundary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = []
    for j, L in enumerate(lengths):
        dtype = dtypes[j % len(dtypes)]
        shift = 1 if j in misaligned else 0
        w, g, w0 = (torch.randn(L + shift, device=device, generator=gen).to(dtype)[shift:]
                    for _ in range(3))
        table.append((w, g, w0))
    return table


def _launches_for(table):
    """One launch per dtype per max_leaves() leaves with at least one element."""
    cap = fu.max_leaves()
    per = {}
    for w, _, _ in table:
        if w.numel():
            per[w.dtype] = per.get(w.dtype, 0) + 1
    return sum(-(-c // cap) for c in per.values())


@pytest.mark.parametrize("lr,mu,wd", HYPER)
@pytest.mark.parametrize(
    "lengths,dtypes,misaligned",
    [(MLP_STEP, [torch.float32], ()), (CNN_STEP, [torch.float32], ()),
     (MLP_STEP, [torch.bfloat16], ()), (MLP_STEP, [torch.float32, torch.bfloat16], ()),
     (EDGE_STEP, [torch.float32], (0, 3, 6)), (EDGE_STEP, [torch.bfloat16, torch.float32], (2, 3))],
)
def test_fused_update_many_bit_equal_per_leaf(cuda, lengths, dtypes, misaligned, lr, mu, wd):
    table = _table(lengths, dtypes, cuda, seed=len(lengths), misaligned=misaligned)
    ws, gs, w0s = (list(t) for t in zip(*table))
    before = fu.launches
    outs = fu.fused_update_many(ws, gs, w0s, lr=lr, mu=mu, wd=wd)
    torch.cuda.synchronize()
    assert fu.launches == before + _launches_for(table)
    for w, g, w0, out in zip(ws, gs, w0s, outs):
        assert out.dtype == w.dtype and out.shape == w.shape
        assert torch.equal(out, ref.fused_update_ref(w, g, w0, lr, mu, wd))
    bufs = [w.clone() for w in ws]  # in place through the ops entry
    ops.fused_update_leaves(bufs, gs, w0s, lr=lr, mu=mu, wd=wd, donate=True)
    torch.cuda.synchronize()
    assert all(torch.equal(b, o) for b, o in zip(bufs, outs))


def test_fused_update_many_past_one_parameter_table(cuda):
    """More leaves than one launch's parameter table holds: ceil(leaves /
    max_leaves()) launches per dtype, every leaf still bit-equal."""
    n = 2 * fu.max_leaves() + 5
    lengths = [(37 * j) % 3001 for j in range(n)]  # includes 0 and odd lengths
    table = _table(lengths, [torch.float32, torch.bfloat16], cuda, seed=11, misaligned=range(0, n, 7))
    ws, gs, w0s = (list(t) for t in zip(*table))
    before = fu.launches
    outs = fu.fused_update_many(ws, gs, w0s, lr=0.05, mu=0.1, wd=0.01)
    torch.cuda.synchronize()
    assert fu.launches - before == _launches_for(table) >= 4
    for w, g, w0, out in zip(ws, gs, w0s, outs):
        assert torch.equal(out, ref.fused_update_ref(w, g, w0, 0.05, 0.1, 0.01))


def test_fused_update_at_mu_wd_zero_never_reads_the_anchor(cuda):
    """At mu = wd = 0 the kernel computes fma(-lr, g, w), as the plain
    version does: a non-finite anchor changes nothing (parity rule 8)."""
    w, g = torch.randn(4099, device=cuda), torch.randn(4099, device=cuda)
    w0 = torch.full_like(w, float("inf"))
    w0[::3] = float("nan")
    out = fu.fused_update(w, g, w0, lr=0.2)
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref.fused_update_ref(w, g, torch.zeros_like(w), 0.2, 0.0, 0.0))
    assert torch.equal(out, ref.fused_update_ref(w, g, w0, 0.2, 0.0, 0.0))


# -- the policy update at the planners' masks ----------------------------------------


def _policy_masked(N, K, M, kind, device, seed):
    """(pi, mask, cand, rs) with ``kind`` masks: "ones" (the planners'),
    "mixed" (most rows one shared partial pattern, every third row its own,
    every fifth all ones: blocks whose first row is shared or distinct) or
    "partial" (random rows, a quarter full).  cand: M Dirichlet rows with
    a duplicate (an exact tie)."""
    gen = torch.Generator().manual_seed(seed)
    e = -torch.log(torch.rand(M, K, generator=gen))
    cand = e / e.sum(-1, keepdim=True)
    if M > 2:
        cand[M - 1] = cand[1]
    if kind == "ones":
        mask = torch.ones(N, K, dtype=torch.bool)
    else:
        mask = torch.rand(N, K, generator=gen) < 0.75
        mask[:, 0] = True
        if kind == "mixed":
            shared = mask[0].clone()
            keep = torch.arange(N) % 3 == 0
            mask = torch.where(keep[:, None], mask, shared[None])
            mask[::5] = True
        else:
            mask[: N // 4] = True
    pi = torch.rand(N, K, generator=gen) * mask
    pi[1::7] = torch.where(mask[1::7], 1e-12, 0.0)
    pi[1::7, 0] = 1.0
    pi = pi / pi.sum(-1, keepdim=True)
    rs = torch.rand(N, K, generator=gen) * 3 * (torch.rand(N, K, generator=gen) < 0.5) * mask
    rs[::5] = 0.0
    return [t.to(device).contiguous() for t in (pi, mask, cand.float(), rs.float())]


@pytest.mark.parametrize("kind", ["ones", "mixed", "partial"])
@pytest.mark.parametrize(
    "N,K,M",
    [(128, 8, 17), (10_000, 16, 25), (128, 36, 45), (3000, 16, 70), (777, 8, 100), (50, 64, 73),
     (1, 1, 3), (33, 2, 200)],
)
def test_policy_update_kernel_at_mask_kinds(cuda, N, K, M, kind):
    """Bit-equal to the plain version, and the same rho (alpha = 0) and pi~
    (alpha = beta = 1) on every node, at M > 32 and M > 64 too."""
    pi, mask, cand, rs = _policy_masked(N, K, M, kind, cuda, seed=N + K + M)
    for alpha, beta in ((0.98, 0.5), (0.0, 0.5), (1.0, 1.0)):
        before = pu.launches
        out = pu.policy_update(pi, mask, cand, rs, tau=8, alpha=alpha, beta=beta)
        torch.cuda.synchronize()
        assert pu.launches == before + 1
        assert torch.equal(out, ref.policy_update_ref(pi, mask, cand, rs, 8, alpha, beta))


# -- FedAvg / DP and the dense decoder on the card --------------------------------


def test_module_tree_aggregate_launches_the_kernel(cuda):
    x = torch.randn(12, 6792, device=cuda)
    w = torch.rand(12, device=cuda)
    before = ta.launches
    out = ta.tree_aggregate(x, w)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    assert torch.equal(out, ref.tree_aggregate_groups_chain(x[None], w[None])[0])


def _deltas_on(device, n=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [{"w1": torch.randn(32, 64, generator=gen), "b1": torch.randn(64, generator=gen),
             "w2": torch.randn(64, 8, generator=gen)} for _ in range(n)], gen


def test_fedavg_and_pairwise_on_card_match_cpu_and_the_kernel(cuda):
    from repro_torch.fl import aggregation as agg
    from repro_torch.pytree import leaves

    deltas, gen = _deltas_on("cpu")
    w = (torch.rand(16, generator=gen) + 0.1).tolist()
    on = [{k: v.to(cuda) for k, v in d.items()} for d in deltas]
    cpu, card = agg.fedavg(deltas, w), agg.fedavg(on, w)
    kernel = ops.tree_aggregate_pytree(on, torch.tensor(w) / sum(w))
    acc = None
    for d, wi in zip(on, (torch.tensor(w) / sum(w)).tolist()):
        acc = agg.pairwise_accumulate(acc, d, wi)
    for a, b, k, p in zip(leaves(card), leaves(cpu), leaves(kernel), leaves(acc)):
        assert torch.equal(a.cpu(), b)  # elementwise f32 ops: the same bits
        torch.testing.assert_close(k, a, **TOL)
        torch.testing.assert_close(p, a, **TOL)


def test_dp_sanitize_on_card_matches_cpu(cuda):
    from repro_torch.fl import dp
    from repro_torch.pytree import leaves

    deltas, gen = _deltas_on("cpu", n=1)
    draws = [torch.randn(t.shape, generator=gen) for t in leaves(deltas[0])]
    cpu = dp.dp_sanitize(deltas[0], draws, clip=1.0, sigma=0.5)
    card = dp.dp_sanitize({k: v.to(cuda) for k, v in deltas[0].items()}, draws, clip=1.0, sigma=0.5)
    for a, b in zip(leaves(card), leaves(cpu)):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    gen_cpu = dp.gaussianize(deltas[0], torch.Generator().manual_seed(3), 0.1)
    gen_card = dp.gaussianize({k: v.to(cuda) for k, v in deltas[0].items()},
                              torch.Generator().manual_seed(3), 0.1)
    for a, b in zip(leaves(gen_card), leaves(gen_cpu)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-8b", "llava-next-34b"])
def test_reduced_lm_on_card_matches_cpu(cuda, arch):
    """f32 with TF32 off (PyTorch's default): logits within 1e-5 of the CPU
    run's, greedy serve tokens identical, decode within 5e-4 of train."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.pytree import tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    on = tree_map(lambda t: t.to(cuda), params)
    batch = serve.make_batch(cfg, 4, 64, torch.Generator().manual_seed(1), "cpu")
    on_batch = {k: v.to(cuda) for k, v in batch.items()}
    cpu_logits = lm.forward(params, cfg, mode="train", **batch)[0]
    card_logits = lm.forward(on, cfg, mode="train", **on_batch)[0]
    torch.testing.assert_close(card_logits.cpu(), cpu_logits, rtol=1e-5, atol=1e-5)
    res_cpu = serve.generate(params, cfg, batch, 8)
    res_card = serve.generate(on, cfg, on_batch, 8)
    assert torch.equal(res_card["tokens"].cpu(), res_cpu["tokens"])


@pytest.mark.parametrize("window", [None, 40])
def test_reduced_lm_multi_chunk_on_card_matches_cpu(cuda, window):
    """S = 128 at the reduced attn_chunk 64: two query and two key chunks,
    so the online softmax carries its running max and sum across chunks
    (windowed: the first key chunk partly masked for the second query
    chunk).  f32 with TF32 off: logits within 1e-5 of the CPU run's, and
    the attention core alone too."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import attention, lm
    from repro_torch.pytree import tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced("tinyllama-1.1b").replace(window=window)
    S = 2 * cfg.attn_chunk
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    on = tree_map(lambda t: t.to(cuda), params)
    batch = serve.make_batch(cfg, 2, S, torch.Generator().manual_seed(1), "cpu")
    cpu_logits = lm.forward(params, cfg, mode="train", **batch)[0]
    card_logits = lm.forward(on, cfg, mode="train", **{k: v.to(cuda) for k, v in batch.items()})[0]
    torch.testing.assert_close(card_logits.cpu(), cpu_logits, rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, S, cfg.num_heads, cfg.head_dim, generator=gen) for _ in range(3))
    kw = dict(chunk_q=cfg.attn_chunk, chunk_kv=cfg.attn_chunk, window=window)
    torch.testing.assert_close(
        attention.chunked_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw).cpu(),
        attention.chunked_attention(q, k, v, **kw), rtol=1e-5, atol=1e-5)


def test_bf16_decode_matches_train_on_card(cuda):
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_reduced("qwen3-8b").replace(dtype="bfloat16", param_dtype="bfloat16")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    B, S, P0 = 4, 48, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1)).to(cuda)
    full = lm.forward(params, cfg, tokens=tokens, mode="train")[0]
    cache = serve.merge_cache(lm.init_cache(cfg, B, S, device=cuda),
                              lm.forward(params, cfg, tokens=tokens[:, :P0], mode="prefill")[1])
    bound = 2.0**-4 * float(full.float().abs().max())
    for t in range(P0, S):
        lt, cache, _ = lm.forward(params, cfg, tokens=tokens[:, t:t + 1], mode="decode",
                                  cache=cache, cache_index=t)
        assert float((lt[:, 0].float() - full[:, t].float()).abs().max()) < bound


@pytest.mark.parametrize("window", [None, 40])
def test_flash_backward_on_card_matches_cpu(cuda, window):
    """The reduced config's attention at S = 128: two query and two key
    chunks of 64, causal, with and without a window.  f32 with TF32 off:
    dq, dk, dv within 1e-5 of the CPU's."""
    from repro_torch import configs
    from repro_torch.models import attention

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced("tinyllama-1.1b")
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 2 * cfg.attn_chunk, cfg.num_heads, cfg.head_dim, generator=gen)
                   for _ in range(4))
    kw = dict(chunk_q=cfg.attn_chunk, chunk_kv=cfg.attn_chunk, window=window)
    grads = {}
    for dev in ("cpu", cuda):
        xs = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            attention.chunked_attention(*xs, **kw), xs, do.to(dev))]
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_reduced_train_step_on_card_matches_cpu(cuda):
    """One AdamW train step of the reduced tinyllama (f32, TF32 off, S = 128,
    remat on): loss within rtol 1e-6, every gradient and AdamW m within
    1e-5 of its leaf's largest magnitude."""
    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.pytree import leaves, tree_map

    cfg = configs.get_reduced("tinyllama-1.1b").replace(remat=True)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, 128, 4), 0, None, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        g, m = steps.grads_and_metrics(cfg, RunPlan(), p, b)
        new, _ = steps.build_train_step(cfg, RunPlan())(steps.init_train_state(cfg, p), b)
        out[str(dev)] = (float(m["loss"]), [t.cpu() for t in leaves(g)],
                         [t.cpu() for t in leaves(new["opt"]["m"])])
    (lc, gc, mc), (lg, gg, mg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-6 * abs(lc)
    for a, b in zip(gg + mg, gc + mc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_reduced_recurrent_lm_on_card_matches_cpu(cuda, arch):
    """RWKV-6 and jamba's Mamba + attention + MoE hybrid, reduced, f32 with
    TF32 off: train-forward logits within 1e-5 of the CPU run's (S = 80:
    5 wkv / scan chunks of 16), prefill logits and every cache leaf (wkv
    state, token shifts, conv history, SSM state, k and v) within 1e-5,
    and greedy serve tokens identical."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.pytree import leaves, tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    on = tree_map(lambda t: t.to(cuda), params)
    batch = serve.make_batch(cfg, 4, 80 if arch.startswith("rwkv") else 64,
                             torch.Generator().manual_seed(1), "cpu")
    on_batch = {k: v.to(cuda) for k, v in batch.items()}
    torch.testing.assert_close(lm.forward(on, cfg, mode="train", **on_batch)[0].cpu(),
                               lm.forward(params, cfg, mode="train", **batch)[0],
                               rtol=1e-5, atol=1e-5)
    (lc, cc, _), (lg, cg, _) = (lm.forward(p, cfg, mode="prefill", **b)
                                for p, b in ((params, batch), (on, on_batch)))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    for a, b in zip(leaves(cg), leaves(cc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    res_cpu = serve.generate(params, cfg, batch, 8)
    res_card = serve.generate(on, cfg, on_batch, 8)
    assert torch.equal(res_card["tokens"].cpu(), res_cpu["tokens"])


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_reduced_recurrent_train_step_on_card_matches_cpu(cuda, arch):
    """One step of each config's own optimizer (rwkv6-7b: AdamW; jamba:
    adafactor), reduced, f32 with TF32 off, S = 64, remat on (the chunk
    loops' checkpoints nested in the blocks'): loss and aux within rtol
    1e-6, every gradient within 1e-5 of its leaf's largest magnitude."""
    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.pytree import leaves, tree_map

    cfg = configs.get_reduced(arch).replace(remat=True)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, 64, 4), 0, None, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        g, m = steps.grads_and_metrics(cfg, RunPlan(), p, b)
        new, m1 = steps.build_train_step(cfg, RunPlan())(steps.init_train_state(cfg, p), b)
        out[str(dev)] = (float(m["loss"]), float(m["aux"]), [t.cpu() for t in leaves(g)],
                         float(m1["loss"]))
    (lc, ac, gc, sc), (lg, ag, gg, sg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-6 * abs(lc) and abs(sg - sc) <= 1e-6 * abs(sc)
    assert abs(ag - ac) <= 1e-6 * max(abs(ac), 1e-30)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_reduced_encdec_on_card_matches_cpu(cuda):
    """seamless-m4t-medium reduced (2 + 2 layers, G = 2 in the
    cross-attention's core), f32 with TF32 off, 128 source frames and 64
    target tokens: train-forward logits within 1e-5 of the CPU run's, the
    prefill's logits and every cache leaf (self and cross k and v) within
    1e-5, and greedy serve tokens identical."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.pytree import leaves, tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced("seamless-m4t-medium")
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {"embeds": torch.randn((4, 128, cfg.d_model), generator=gen) * 0.3,
             "tokens": torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, dtype=torch.int32)}
    on = tree_map(lambda t: t.to(cuda), params)
    on_batch = {k: v.to(cuda) for k, v in batch.items()}
    torch.testing.assert_close(encdec.forward(on, cfg, on_batch).cpu(),
                               encdec.forward(params, cfg, batch), rtol=1e-5, atol=1e-5)
    (cc, lc), (cg, lg) = (encdec.prefill(p, cfg, b) for p, b in ((params, batch), (on, on_batch)))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    for a, b in zip(leaves(cg), leaves(cc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    res_cpu = serve.generate(params, cfg, batch, 8)
    res_card = serve.generate(on, cfg, on_batch, 8)
    assert torch.equal(res_card["tokens"].cpu(), res_cpu["tokens"])


def test_reduced_encdec_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of the reduced seamless-m4t-medium (f32, TF32 off,
    S_src = S_tgt = 64, remat on: every encoder and decoder layer
    recomputed): loss within rtol 1e-6, every gradient within 1e-5 of its
    leaf's largest magnitude, the step's loss within rtol 1e-6."""
    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.models import encdec
    from repro_torch.pytree import leaves, tree_map

    cfg = configs.get_reduced("seamless-m4t-medium").replace(remat=True)
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg)
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, 64, 4), 0, None, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        g, m = steps.grads_and_metrics(cfg, RunPlan(), p, b)
        _, m1 = steps.build_train_step(cfg, RunPlan())(steps.init_train_state(cfg, p), b)
        out[str(dev)] = (float(m["loss"]), [t.cpu() for t in leaves(g)], float(m1["loss"]))
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-6 * abs(lc) and abs(sg - sc) <= 1e-6 * abs(sc)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_q8_hop_lattice_on_card_bit_equal_to_cpu(cuda):
    """The podded step's hop on the card: one quantize and one dequantize
    launch per leaf; the lattice, the scales and the pod mean bit-equal to
    the CPU's plain versions (``q * s`` rounded once, then ``(a + b) / 2``,
    IEEE on both)."""
    from repro_torch.fl import steps

    gen = torch.Generator().manual_seed(5)
    g = {"a": torch.randn(2, 22, 2048, generator=gen) * 1e-3, "b": torch.randn(2, 300, generator=gen),
         "c": torch.randn(2, 4, 256, 256, generator=gen)}
    on = {k: v.to(cuda) for k, v in g.items()}
    before = dict(qz.launches)
    agg_card = steps.q8_mean_over_pods(on)
    torch.cuda.synchronize()
    assert qz.launches["qsgd_quantize"] == before["qsgd_quantize"] + 3
    assert qz.launches["qsgd_dequantize"] == before["qsgd_dequantize"] + 3
    agg_cpu = steps.q8_mean_over_pods(g)
    for k in g:
        rows = steps.pod_rows(g[k])
        half = torch.full_like(rows, 0.5)
        q, s = ops.qsgd_quantize(rows.to(cuda), half.to(cuda))
        rq, rs = ops.qsgd_quantize(rows, half)
        assert torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)
        assert torch.equal(agg_card[k].cpu(), agg_cpu[k])


def test_cross_pod_q8_on_card_through_a_gloo_group(cuda, tmp_path):
    """``hierarchy.cross_pod_q8`` on CUDA tensors over a gloo ``pod`` group
    of one rank: its rows and scales go through pinned host buffers; one
    quantize and one dequantize launch a leaf; bit-equal to
    ``q8_mean_over_pods`` of the one pod on the card."""
    import torch.distributed as dist

    from repro_torch.fl import hierarchy, steps
    from repro_torch.launch import mesh as mesh_mod

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod._mk((1, 1, 1), ("pod", "data", "model"), "cuda")
        gen = torch.Generator().manual_seed(6)
        g = {"a": torch.randn(22, 2048, generator=gen).to(cuda),
             "b": torch.randn(300, generator=gen).to(cuda)}
        before = dict(qz.launches)
        got = hierarchy.cross_pod_q8(g, 1, mesh=mesh)
        torch.cuda.synchronize()
        assert qz.launches["qsgd_quantize"] == before["qsgd_quantize"] + 2
        assert qz.launches["qsgd_dequantize"] == before["qsgd_dequantize"] + 2
        want = steps.q8_mean_over_pods({k: v[None] for k, v in g.items()})
        for k in g:
            assert got[k].is_cuda and torch.equal(got[k], want[k])
    finally:
        dist.destroy_process_group()


def _sharded_rank(rank: int, tmp: str) -> None:
    """One of two gloo ranks sharing the card: one sharded step of reduced
    tinyllama on a (data 1, model 2) mesh; rank 0 saves the whole state."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.pytree import tree_map

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2)
    try:
        mesh = mesh_mod._mk((1, 2), ("data", "model"), "cuda")
        run = train.train(configs.get_reduced("tinyllama-1.1b"), RunPlan(), steps=1, seq_len=128,
                          global_batch=4, device="cuda", mesh=mesh, log=lambda *a: None)
        state = tree_map(lambda t: t.full_tensor().cpu(), run["state"])
        if rank == 0:
            torch.save({"losses": run["losses"], "state": state,
                        "wire": mesh_mod.wire_stats()}, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


def test_sharded_step_on_card_matches_the_single_process_step(cuda, tmp_path):
    """Two gloo ranks on the card, ``model`` 2 (heads, the FF dim and the
    vocabulary split over them, the sequence-parallel residual): one step
    of ``launch/train.train(mesh=...)``, its collectives staged through
    pinned host buffers (``launch/mesh.stage_through_host``); the loss and
    every state leaf fp-tight (rtol 1e-4, atol 1e-5) against the same step
    in one process on the card."""
    import torch.multiprocessing as mp

    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.launch import train
    from repro_torch.pytree import key_paths, leaves

    mp.start_processes(_sharded_rank, args=(str(tmp_path),), nprocs=2, start_method="spawn",
                       join=True)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    want = train.train(configs.get_reduced("tinyllama-1.1b"), RunPlan(), steps=1, seq_len=128,
                       global_batch=4, device=cuda, log=lambda *a: None)
    assert got["wire"]["all_gather_into_tensor"]["calls"] > 0
    torch.testing.assert_close(torch.tensor(got["losses"]), torch.tensor(want["losses"]),
                               rtol=1e-4, atol=1e-5)
    assert key_paths(got["state"]) == key_paths(want["state"])
    for path, a, b in zip(key_paths(want["state"]), leaves(got["state"]), leaves(want["state"])):
        torch.testing.assert_close(a, b.cpu(), rtol=1e-4, atol=1e-5, msg=path)
