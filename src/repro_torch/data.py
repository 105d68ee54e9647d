"""Data pipeline: deterministic synthetic streams + non-IID federated partitioning.

Each data-parallel shard (FL client group) derives its own stream from
(seed, shard_id, step) so multi-host loading needs no coordination — the
same recipe a real cluster loader would use with a sharded index.

The synthetic LM stream is a Zipf-ish token model with shard-dependent
class skew so FedAvg-vs-centralized comparisons see genuinely non-IID
clients; ``dirichlet_partition`` reproduces the classic FL non-IID split
for the paper-scale (small-model) benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StreamConfig:
    vocab_size: int
    seq_len: int
    batch_per_shard: int
    seed: int = 0
    non_iid_alpha: float = 0.0  # >0 => shard-skewed token distribution


def _rng(seed: int, shard: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, shard, step]))


def lm_batch(sc: StreamConfig, shard: int, step: int) -> dict[str, np.ndarray]:
    """One (tokens, labels) batch for a shard.  Deterministic in (seed, shard, step)."""
    rng = _rng(sc.seed, shard, step)
    if sc.non_iid_alpha > 0:
        # shard-specific Zipf tilt: each client group favours a token slice
        base = np.arange(1, sc.vocab_size + 1, dtype=np.float64) ** -1.1
        roll = (shard * 97) % sc.vocab_size
        p = np.roll(base, roll)
        p /= p.sum()
        tokens = rng.choice(sc.vocab_size, size=(sc.batch_per_shard, sc.seq_len + 1), p=p)
    else:
        tokens = rng.integers(0, sc.vocab_size, size=(sc.batch_per_shard, sc.seq_len + 1))
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def embeds_batch(sc: StreamConfig, d_model: int, shard: int, step: int) -> np.ndarray:
    rng = _rng(sc.seed, shard, step)
    return rng.standard_normal((sc.batch_per_shard, sc.seq_len, d_model)).astype(np.float32) * 0.3


# ---------------------------------------------------------------------------
# learnable synthetic task (for convergence tests / time-to-accuracy benches):
# next token = (a * tok + b) % V with noise — a model can actually learn it.


def learnable_lm_batch(sc: StreamConfig, shard: int, step: int, noise: float = 0.05):
    rng = _rng(sc.seed, shard, step)
    B, S, V = sc.batch_per_shard, sc.seq_len, sc.vocab_size
    a, b = 7, 3
    start = rng.integers(0, V, size=(B, 1))
    seq = [start]
    for _ in range(S):
        nxt = (a * seq[-1] + b) % V
        flip = rng.random((B, 1)) < noise
        nxt = np.where(flip, rng.integers(0, V, size=(B, 1)), nxt)
        seq.append(nxt)
    toks = np.concatenate(seq, axis=1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# classic FL non-IID partition (for small-model paper benchmarks)


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    seed: int = 0,
    min_samples: int = 1,
) -> list[np.ndarray]:
    """Partition sample indices across clients with Dirichlet(alpha) class skew.

    At low ``alpha`` the draw concentrates whole classes on few clients
    and can leave clients with *zero* samples — downstream, an all-empty
    shard turns the engine's masked padding into dead weight-0 workers
    (and callers used to paper over it with bogus fallback indices).
    ``min_samples`` (default 1) guarantees every client at least that
    many samples by deterministically reassigning from the currently
    largest clients (stable index tie-break), preserving the skew
    everywhere else.  ``min_samples=0`` reproduces the raw draw.
    Requires ``len(labels) >= num_clients * min_samples``.
    """
    if min_samples > 0 and len(labels) < num_clients * min_samples:
        raise ValueError(
            f"cannot give {num_clients} clients >= {min_samples} samples "
            f"from {len(labels)} total"
        )
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    idx_by_client: list[list[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            idx_by_client[client].extend(part.tolist())
    for client in range(num_clients):
        while len(idx_by_client[client]) < min_samples:
            donor = max(
                range(num_clients), key=lambda i: (len(idx_by_client[i]), -i)
            )
            idx_by_client[client].append(idx_by_client[donor].pop())
    return [np.asarray(sorted(v), dtype=np.int64) for v in idx_by_client]


def synthetic_classification(
    n: int, dim: int, num_classes: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Linearly-separable-ish synthetic classification set (paper-scale models)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_classes, dim)) * 2.0
    y = rng.integers(0, num_classes, size=n)
    x = centers[y] + rng.standard_normal((n, dim))
    return x.astype(np.float32), y.astype(np.int32)


def global_batch_to_host_arrays(per_shard_batches: list[dict]) -> dict:
    """Stack per-shard batches into the global batch (shard-major order)."""
    keys = per_shard_batches[0].keys()
    return {k: np.concatenate([b[k] for b in per_shard_batches], axis=0) for k in keys}
