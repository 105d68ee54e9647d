"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Whether a card is present is decided inside the ``cuda`` fixture, never
at import, so every pytest worker collects the same tests; without a
card each test skips with that reason.  Tolerance rtol = atol = 1e-5.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
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
