"""NodeIds: (m+n)-bit ids — m-bit zone prefix, n-bit intra-zone suffix.

Paper §IV-B: NodeId D = P * 2^n + S.  AppIds come from SHA-1 of the
application's textual name (+ creator key + salt), uniformly distributed.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True)
class IdSpace:
    zone_bits: int  # m
    suffix_bits: int  # n

    @property
    def total_bits(self) -> int:
        return self.zone_bits + self.suffix_bits

    @property
    def num_zones(self) -> int:
        return 1 << self.zone_bits

    @property
    def suffix_space(self) -> int:
        return 1 << self.suffix_bits

    def make(self, zone: int, suffix: int) -> int:
        assert 0 <= zone < self.num_zones and 0 <= suffix < self.suffix_space
        return zone * self.suffix_space + suffix

    def zone_of(self, node_id: int) -> int:
        return node_id >> self.suffix_bits

    def suffix_of(self, node_id: int) -> int:
        return node_id & (self.suffix_space - 1)


def sha1_id(text: str, bits: int, salt: str = "") -> int:
    """AppId = hash(app name | creator key | salt), SHA-1 (paper §IV-C)."""
    h = hashlib.sha1((text + "|" + salt).encode()).digest()
    return int.from_bytes(h, "big") % (1 << bits)


def ring_distance(a: int, b: int, space: int) -> int:
    """Clockwise distance a -> b on a ring of size `space`."""
    return (b - a) % space


def abs_ring_distance(a: int, b: int, space: int) -> int:
    d = (b - a) % space
    return min(d, space - d)


def numerically_closest(key: int, ids, space: int) -> int:
    """The id numerically closest to key on the ring (ties -> clockwise)."""
    best, best_d = None, None
    for i in ids:
        d = abs_ring_distance(key, i, space)
        if best_d is None or d < best_d or (d == best_d and ring_distance(key, i, space) <= ring_distance(key, best, space)):
            best, best_d = i, d
    return best
