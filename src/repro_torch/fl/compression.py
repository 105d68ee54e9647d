"""Compressed transport for commits and broadcasts, on tensors.

Answers to ``repro/fl/compression.py``.  A ``CompressionPolicy`` (copied
as it is, wire math included) rides on ``AppHandle.compression`` or the
async scheduler's ``app_compression`` knob:

- commit (uplink) axis: ``quantize_delta`` serializes a worker's update
  pytree into a ``QuantizedDelta`` (int8 lattice + per-chunk f32 scales,
  tensors on the delta's device), ``CommitDelta`` buffers it as it is,
  and ``ApplyBuffered`` dequantizes inside the buffered aggregation
  (``kernels.ops.buffered_aggregate_quantized``, the int8 aggregation
  kernel);
- broadcast (downlink) axis: ``quantize_broadcast_delta`` quantizes one
  version delta on the coarse ``downlink_levels`` lattice, and
  ``apply_delta_chain`` folds a chain of them into held params in one
  fused pass (``kernels.ops.apply_quantized_broadcast``).

With 256-value chunks, quantization runs the ``qsgd_quantize`` kernel;
other chunk widths take the plain eager arithmetic, as the reference does
(``kernels.ref.quantize_ref_truediv``).  Error feedback under qsgd-int8 at
256-value chunks takes its residual from the quantize launch itself
(``quantize_delta_with_residual``); ``dequantize_delta`` and
``QuantizedDelta.dequantize`` run the ``qsgd_dequantize`` kernel.

Rounding uniforms: the reference folds (seed, lane, app, commit number or
version) into a threefry key, which PyTorch cannot reproduce.  The port
keeps the semantics -- one draw per (policy seed, lane, app, n) -- in
``rounding_uniforms``, which draws on the CPU with a seeded
``torch.Generator`` and moves the result to the delta's device, so a run
on the card and one on the CPU round with the same uniforms.  Tests that
hold the port to the reference bit for bit replace that one function
with the reference's draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import ref as kref
from ..pytree import ravel, tree_map, unravel_like

COMMIT_LANE = 0  # rounding lane of commit deltas (key = (lane, app, commit seq))
BROADCAST_LANE = 0x0D0C  # rounding lane of broadcast deltas (key = (lane, app, version))


def rounding_uniforms(policy, lane: int, app_idx: int, n: int, shape, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape`` for one (policy seed, lane, app,
    n) -- n is the commit sequence number or the model version.

    A fixed key reproduces the wire bytes exactly; distinct keys draw
    decorrelated uniforms.  Drawn on the CPU whatever ``device`` is.
    """
    seed = np.random.SeedSequence(
        [int(policy.seed), int(lane), int(app_idx), int(n)]
    ).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand(tuple(shape), generator=gen, dtype=torch.float32).to(device)


def qsgd_quantize(x: torch.Tensor, *, levels: int = 127, rand=None):
    """Stochastic int8 quantization with a per-row scale (eager arithmetic).

    x: (..., d) -> (q int8, scale f32 (..., 1)); ``rand`` holds uniforms
    in [0, 1), by default 0.5 everywhere (deterministic round-half-down).
    """
    if rand is None:
        rand = torch.full(x.shape, 0.5, dtype=torch.float32, device=x.device)
    return kref.quantize_ref_truediv(x, rand, levels=levels)


def qsgd_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def signsgd_compress(x: torch.Tensor):
    """1-bit sign compression with mean-|x| scale."""
    xf = x.float()
    return torch.sign(xf).to(torch.int8), xf.abs().mean(dim=-1, keepdim=True)


def signsgd_decompress(s: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return s.float() * scale


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top-``frac`` fraction by |value| (per leading row)."""
    xf = x.float()
    flat = xf.reshape(xf.shape[0], -1) if xf.dim() > 1 else xf[None]
    k = max(1, int(flat.shape[-1] * frac))
    idx = torch.topk(flat.abs(), k, dim=-1).indices
    out = torch.zeros_like(flat).scatter(-1, idx, flat.gather(-1, idx))
    return out.reshape(xf.shape)


def error_feedback_update(x: torch.Tensor, err: torch.Tensor, compress_fn):
    """EF-SGD: compress (x + err), carry the residual forward."""
    target = x.float() + err
    c, scale = compress_fn(target)
    approx = c.float() * scale
    return (c, scale), target - approx


# -- per-app commit compression policy (bytes on the wire) ---------------------

_KINDS = ("none", "qsgd-int8", "signsgd", "topk")
_DOWNLINK_KINDS = ("none", "qsgd-int8", "delta-qsgd")


@dataclass(frozen=True)
class CompressionPolicy:
    """Per-app compression for both wire directions (paper Table II's
    per-app compression hooks, made first-class for the transport model).

    Commit (uplink) axis — ``kind``: ``"none"`` (full f32 payloads, the
    byte-identical default), ``"qsgd-int8"`` (QSGD stochastic int8, one
    f32 max-abs scale per ``chunk`` elements), ``"signsgd"`` (1-bit sign
    + per-chunk mean-|x| scale, ref [38]), or ``"topk"`` (keep the
    ``topk_frac`` fraction by |value|, QSGD-quantized; wire ships int8
    value + i32 index per survivor).  ``levels`` is the quantization
    grid per sign (<= 127 so the lattice fits int8).  ``seed`` roots the
    per-commit rounding draws (``rounding_uniforms``).  ``error_feedback``
    turns on EF-SGD: the trainer carries each worker's residual
    ``x - deq(q(x))`` into its next commit, so aggressive ``levels``
    settings stay unbiased over rounds.

    Broadcast (downlink) axis — ``downlink``: ``"none"`` (full f32
    broadcasts, byte-identical to the uncompressed path),
    ``"qsgd-int8"`` (each new version ships quantized at ``levels``), or
    ``"delta-qsgd"`` (version deltas quantized at ``downlink_levels``
    and packed at ``downlink_bits`` bits/element; workers <= ``chain_cap``
    versions behind download the chained deltas, everyone else the full
    f32 state)."""

    kind: str = "none"
    levels: int = 127
    chunk: int = 256
    seed: int = 0
    topk_frac: float = 0.01
    error_feedback: bool = False
    downlink: str = "none"
    downlink_levels: int = 7
    chain_cap: int = 3

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"compression kind must be one of {_KINDS}, got {self.kind!r}")
        if not 1 <= int(self.levels) <= 127:
            raise ValueError(f"levels must be in [1, 127] (int8 lattice), got {self.levels!r}")
        if int(self.chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk!r}")
        if not 0.0 < float(self.topk_frac) <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got {self.topk_frac!r}")
        if self.downlink not in _DOWNLINK_KINDS:
            raise ValueError(
                f"downlink kind must be one of {_DOWNLINK_KINDS}, got {self.downlink!r}"
            )
        if not 1 <= int(self.downlink_levels) <= 127:
            raise ValueError(
                f"downlink_levels must be in [1, 127] (int8 lattice), "
                f"got {self.downlink_levels!r}"
            )
        if int(self.chain_cap) < 1:
            raise ValueError(f"chain_cap must be >= 1, got {self.chain_cap!r}")

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    @property
    def downlink_enabled(self) -> bool:
        return self.downlink != "none"

    def _rows(self, payload_bytes: float) -> int:
        return max(1, math.ceil(float(payload_bytes) / 4.0 / self.chunk))

    def wire_bytes(self, payload_bytes: float) -> float:
        """Modeled commit bytes on the wire for a ``payload_bytes`` f32
        payload.

        qsgd-int8 serializes n = payload_bytes/4 elements as one int8
        each, padded to whole chunks, plus one f32 scale per chunk —
        exactly ``QuantizedDelta.nbytes`` for a real n-element delta.
        signsgd bit-packs one sign per element (chunk/8 bytes per row)
        plus the per-chunk f32 scale.  topk ships k = ceil(n *
        topk_frac) survivors as int8 value + i32 index pairs plus the
        per-chunk scales.  ``kind="none"`` returns the input unchanged
        (same float object arithmetic as the uncompressed path, so
        pricing is bit-identical)."""
        if not self.enabled:
            return float(payload_bytes)
        n = float(payload_bytes) / 4.0
        rows = self._rows(payload_bytes)
        if self.kind == "signsgd":
            return float(rows * math.ceil(self.chunk / 8) + rows * 4)
        if self.kind == "topk":
            k = max(1, math.ceil(n * float(self.topk_frac)))
            return float(5 * k + rows * 4)
        return float(rows * self.chunk + rows * 4)

    @property
    def downlink_bits(self) -> int:
        """Bits per element of a packed broadcast delta: the minimal
        fixed width for the 2*downlink_levels+1 lattice points."""
        return max(1, math.ceil(math.log2(2 * int(self.downlink_levels) + 1)))

    def delta_wire_bytes(self, payload_bytes: float) -> float:
        """Modeled bytes of ONE quantized version delta: elements packed
        at ``downlink_bits`` bits plus one f32 scale per chunk.  (The
        in-memory ``QuantizedDelta`` keeps int8 — the packed size is the
        wire model, mirrored in ``QuantizedDelta.wire_nbytes``.)"""
        rows = self._rows(payload_bytes)
        return float(rows * math.ceil(self.chunk * self.downlink_bits / 8) + rows * 4)

    def downlink_wire_bytes(self, payload_bytes: float, chain: int | None = None) -> float:
        """Modeled bytes of one broadcast (download) to one worker.

        ``chain`` is the worker's version gap when it qualifies for the
        delta path (``downlink="delta-qsgd"``, base cached, gap <=
        ``chain_cap``) — ``chain=0`` is a version check with no payload,
        ``chain=k`` ships k cached deltas.  ``chain=None`` means the
        full path: the f32 state for ``delta-qsgd`` fallback (and for
        ``downlink="none"``), the quantized full model for
        ``downlink="qsgd-int8"`` (which never chains)."""
        if self.downlink == "delta-qsgd" and chain is not None:
            if int(chain) < 0:
                raise ValueError(f"delta chain must be >= 0, got {chain!r}")
            return float(chain) * self.delta_wire_bytes(payload_bytes)
        if self.downlink == "qsgd-int8":
            rows = self._rows(payload_bytes)
            return float(rows * self.chunk + rows * 4)
        return float(payload_bytes)


def as_policy(value) -> CompressionPolicy | None:
    """Normalize a policy knob: None, a ``CompressionPolicy``, or a kind
    string (``"qsgd-int8"``)."""
    if value is None or isinstance(value, CompressionPolicy):
        return value
    if isinstance(value, str):
        return CompressionPolicy(kind=value)
    raise TypeError(f"expected CompressionPolicy, kind string or None, got {value!r}")


@dataclass(frozen=True)
class QuantizedDelta:
    """One delta serialized for the wire: int8 lattice points + per-chunk
    f32 scales + the structure needed to rebuild the pytree.

    ``q`` is (R, chunk) int8 (the flattened, zero-padded delta), ``scale``
    (R, 1) f32, both on the delta's device.  ``like`` is the delta's
    structure with its leaves as storage-free ``meta`` tensors of their
    shapes.  Padding elements quantize to exactly 0 and are dropped by
    ``unflatten``.  ``wire_nbytes`` overrides the modeled wire size when
    the serialized format is narrower than the int8 grid (bit-packed
    signsgd, sparse topk, packed downlink deltas); ``None`` means the
    tensors ARE the wire format (dense qsgd-int8)."""

    q: torch.Tensor
    scale: torch.Tensor
    length: int                 # unpadded element count
    like: Any
    levels: int
    chunk: int
    wire_nbytes: float | None = None

    @property
    def nbytes(self) -> float:
        """Serialized wire size (what ``CommitDelta`` accounts)."""
        if self.wire_nbytes is not None:
            return float(self.wire_nbytes)
        return float(self.q.nbytes + self.scale.nbytes)

    def unflatten(self, flat: torch.Tensor) -> Any:
        """Rebuild the delta pytree from a flat (>= length,) f32 vector."""
        return unravel_like(flat.reshape(-1)[: self.length], self.like)

    def dequantize(self) -> Any:
        """This delta alone, dequantized (``qsgd_dequantize`` kernel); the
        apply path composes scales with staleness weights instead."""
        return self.unflatten(kops.qsgd_dequantize(self.q, self.scale))


def _flatten_grid(delta, chunk: int):
    """Flatten a pytree onto the (rows, chunk) quantization grid."""
    flat = ravel(delta)
    n = int(flat.numel())
    rows = max(1, math.ceil(n / chunk))
    padded = torch.zeros(rows * chunk, dtype=torch.float32, device=flat.device)
    padded[:n] = flat
    like = tree_map(lambda l: torch.empty(tuple(l.shape), device="meta"), delta)
    return padded.view(rows, chunk), flat, n, like


def _grid_uniforms(x2d: torch.Tensor, policy: CompressionPolicy, key) -> torch.Tensor:
    """The rounding uniforms of one (rows, chunk) grid: ``rounding_uniforms``
    for ``key`` = (lane, app, n), or 0.5 everywhere for None."""
    if key is None:
        return torch.full(tuple(x2d.shape), 0.5, dtype=torch.float32, device=x2d.device)
    return rounding_uniforms(policy, *key, tuple(x2d.shape), x2d.device)


def _qsgd_grid(x2d: torch.Tensor, policy: CompressionPolicy, key, levels: int):
    """QSGD-quantize one (rows, chunk) grid: the kernel when the chunking
    matches its 256-value row, the eager arithmetic otherwise.  ``key`` is
    (lane, app, n) for ``rounding_uniforms``, or None for 0.5."""
    rand = _grid_uniforms(x2d, policy, key)
    if x2d.shape[1] == 256:
        return kops.qsgd_quantize(x2d, rand, levels=levels)
    return qsgd_quantize(x2d, levels=levels, rand=rand)


def quantize_delta(delta, policy: CompressionPolicy, key=None) -> QuantizedDelta:
    """Serialize an update pytree under ``policy`` (must be enabled).

    qsgd-int8 quantizes the (rows, chunk) grid (``_qsgd_grid``); signsgd
    stores signs on the same int8 grid with a per-chunk mean-|x| scale
    over the chunk's real elements; topk zeroes everything below the
    global top-``topk_frac`` cut, then QSGD-quantizes the survivors.
    ``wire_nbytes`` carries the packed/sparse wire model where the int8
    grid overstates it.  ``key`` is (lane, app, commit seq); ``None``
    rounds half-down deterministically (tests only)."""
    if not policy.enabled:
        raise ValueError("quantize_delta requires an enabled policy (kind != 'none')")
    chunk = int(policy.chunk)
    x2d, flat, n, like = _flatten_grid(delta, chunk)
    wire = None
    if policy.kind == "signsgd":
        rows = x2d.shape[0]
        counts = np.clip(n - chunk * np.arange(rows), 1, chunk).astype(np.float32)
        counts_t = torch.from_numpy(counts).to(x2d.device)
        s = x2d.abs().sum(dim=-1, keepdim=True) / counts_t[:, None]
        q = torch.sign(x2d).to(torch.int8)
        wire = policy.wire_bytes(4.0 * n)
    elif policy.kind == "topk":
        k = max(1, math.ceil(n * float(policy.topk_frac)))
        if n > k:
            idx = torch.topk(flat.abs(), k).indices
            x2d = torch.zeros_like(x2d)
            x2d.view(-1)[idx] = flat[idx]
        q, s = _qsgd_grid(x2d, policy, key, int(policy.levels))
        wire = policy.wire_bytes(4.0 * n)
    else:
        q, s = _qsgd_grid(x2d, policy, key, int(policy.levels))
    return QuantizedDelta(
        q=q, scale=s, length=n, like=like, levels=int(policy.levels), chunk=chunk,
        wire_nbytes=wire,
    )


def quantize_delta_with_residual(target, policy: CompressionPolicy, key=None):
    """``quantize_delta`` under a qsgd-int8 policy of 256-value chunks, and
    the error-feedback residual ``target - dequantize`` from the same
    kernel launch (``qsgd_quantize_residual``).

    Returns (the ``QuantizedDelta`` that ``quantize_delta`` gives, the
    residual pytree in f32: views of the grid's first n values).  The grid
    is ``ravel(target)`` padded with zeros, so its first n residuals are the
    reference's ``target - deq`` leaf by leaf.  Other policies have no such
    grid (topk quantizes the sparsified target; signsgd has no QSGD lattice;
    other chunk widths take the eager arithmetic) and are refused."""
    if policy.kind != "qsgd-int8" or int(policy.chunk) != 256:
        raise ValueError(
            f"the fused residual needs kind 'qsgd-int8' at chunk 256, got "
            f"{policy.kind!r} at chunk {policy.chunk!r}"
        )
    x2d, _, n, like = _flatten_grid(target, 256)
    rand = _grid_uniforms(x2d, policy, key)
    q, s, res = kops.qsgd_quantize_residual(x2d, rand, levels=int(policy.levels))
    qd = QuantizedDelta(q=q, scale=s, length=n, like=like, levels=int(policy.levels), chunk=256)
    return qd, unravel_like(res.view(-1)[:n], like)


def dequantize_delta(qd: QuantizedDelta) -> Any:
    """The delta pytree a ``QuantizedDelta`` carries, dequantized
    (``qsgd_dequantize`` kernel)."""
    return qd.dequantize()


# -- downlink: version deltas + fused chain application ------------------------


def quantize_broadcast_delta(delta, policy: CompressionPolicy, key=None) -> QuantizedDelta:
    """Serialize one version delta for the broadcast direction: QSGD on
    the coarse ``downlink_levels`` lattice, ``wire_nbytes`` set to the
    bit-packed size (``delta_wire_bytes``) the scheduler prices chained
    downloads at."""
    if not policy.downlink_enabled:
        raise ValueError(
            "quantize_broadcast_delta requires an enabled downlink (downlink != 'none')"
        )
    chunk = int(policy.chunk)
    x2d, _, n, like = _flatten_grid(delta, chunk)
    levels = int(policy.downlink_levels) if policy.downlink == "delta-qsgd" else int(policy.levels)
    q, s = _qsgd_grid(x2d, policy, key, levels)
    wire = policy.downlink_wire_bytes(4.0 * n, chain=1)
    return QuantizedDelta(
        q=q, scale=s, length=n, like=like, levels=levels, chunk=chunk, wire_nbytes=wire,
    )


def apply_delta_chain(params, deltas: list) -> Any:
    """Fold a chain of quantized version deltas into ``params`` in ONE
    fused dequantize-and-apply pass (``kernels.ops.
    apply_quantized_broadcast``; eager two-rounding adds for other
    chunkings, as the reference does).

    The deltas are accumulated strictly in chain order, element-wise, so
    a stale worker folding its whole gap in one call lands on the same
    reconstruction the master maintained incrementally.  All deltas must
    share one (rows, chunk) grid (same model, same policy)."""
    if not deltas:
        return params
    qd0 = deltas[0]
    rows, chunk = qd0.q.shape
    flat = ravel(params)
    if flat.numel() != qd0.length:
        raise ValueError(
            f"params have {flat.numel()} elements but the chain was built for {qd0.length}"
        )
    w2d = torch.zeros(rows * chunk, dtype=torch.float32, device=flat.device)
    w2d[: flat.numel()] = flat
    w2d = w2d.view(rows, chunk)
    if len(deltas) == 1:  # views, no copies
        q, s = qd0.q[None], qd0.scale[None]
    else:
        q = torch.stack([d.q for d in deltas])      # (D, rows, chunk) int8
        s = torch.stack([d.scale for d in deltas])  # (D, rows, 1) f32
    if chunk == 256:
        out = kops.apply_quantized_broadcast(w2d, q, s)
    else:
        out = w2d
        for d in range(q.shape[0]):
            out = out + q[d].float() * s[d]
    rebuilt = qd0.unflatten(out)
    return tree_map(lambda p, v: v.to(p.dtype), params, rebuilt)
