"""Algorithm-1 policy update: the CUDA kernel's wrapper.

``policy_update`` answers to ``repro/kernels/policy_update.py``'s Pallas
kernel of the same name: lines 5-8 of Algorithm 1 for every node at once
(``ref.policy_update_ref`` says what and in which order).  Dispatch goes
by the tensors' device and nothing else:

- CPU tensors go to the plain version;
- CUDA tensors launch ``csrc/policy_update.cu`` (built for sm_90a at first
  use) or raise.

Any node count N is taken as it is (the reference padded N to its
256-node block with uniform rows for the TPU); K <= 64 hops, any number
M of candidates with M * K <= MAX_CAND_FLOATS.  The kernel computes line
5 once per block for its first node's mask row and reuses it for every
node whose row matches (all of them, with the planners' all-ones masks).
``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import ref as _ref

MAX_K = 64  # two hops per lane of a warp (line 8), two ballot words per mask row
# M * K: the kernel keeps the candidate set (f32) and one mask row's candn
# (f64) in shared memory, 12 * M * K + 4 * M + 4096 bytes, 196 KB at most
# (the opt-in past 48 KB; an H100 block may use 227 KB)
MAX_CAND_FLOATS = 12288

launches = 0  # CUDA kernel launches since the last reset (a plain int)

_fn_cache: list = []


def _fn():
    if not _fn_cache:
        fn = _build.load("policy_update").policy_update_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_float] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def policy_update(pi: torch.Tensor, mask: torch.Tensor, cand: torch.Tensor,
                  reward_sums: torch.Tensor, *, tau: int, alpha: float, beta: float) -> torch.Tensor:
    """pi (N, K) f32, mask (N, K) bool, cand (M, K) f32, reward_sums (N, K)
    f32 -> the updated policies (N, K) f32."""
    global launches
    if pi.dim() != 2 or cand.dim() != 2 or cand.shape[1] != pi.shape[1]:
        raise ValueError(f"pi must be (N, K) and cand (M, K), got {tuple(pi.shape)}, {tuple(cand.shape)}")
    N, K = pi.shape
    M = cand.shape[0]
    if tuple(mask.shape) != (N, K) or tuple(reward_sums.shape) != (N, K):
        raise ValueError(f"mask and reward_sums must be {(N, K)}, got "
                         f"{tuple(mask.shape)}, {tuple(reward_sums.shape)}")
    if not (1 <= K <= MAX_K and 1 <= M and M * K <= MAX_CAND_FLOATS):
        raise ValueError(f"need 1 <= K <= {MAX_K}, M >= 1 and M*K <= {MAX_CAND_FLOATS}; got K={K}, M={M}")
    if (pi.dtype, mask.dtype, cand.dtype, reward_sums.dtype) != (
            torch.float32, torch.bool, torch.float32, torch.float32):
        raise TypeError(f"pi, mask, cand, reward_sums must be float32, bool, float32, float32; got "
                        f"{pi.dtype}, {mask.dtype}, {cand.dtype}, {reward_sums.dtype}")
    ts = (pi, mask, cand, reward_sums)
    if any(t.device != pi.device for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}: one device needed")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("pi, mask, cand and reward_sums must be contiguous")
    if pi.device.type == "cpu":
        return _ref.policy_update_ref(pi, mask, cand, reward_sums, tau, alpha, beta)
    if pi.device.type != "cuda":
        raise ValueError(f"no kernel for device {pi.device}")
    out = torch.empty_like(pi)
    alpha32, beta32 = np.float32(alpha), np.float32(beta)
    with torch.cuda.device(pi.device):
        err = _fn()(pi.data_ptr(), mask.data_ptr(), cand.data_ptr(), reward_sums.data_ptr(),
                    out.data_ptr(), N, K, M, float(tau), float(alpha32), float(beta32),
                    float(np.float32(1.0) - alpha32),
                    torch.cuda.current_stream(pi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"policy_update launch failed: CUDA error {err}")
    launches += 1
    return out
