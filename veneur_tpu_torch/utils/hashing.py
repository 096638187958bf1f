"""Hashing used across the pipeline (the port's copy of
veneur_tpu.utils.hashing: key digests and set-member hashes must agree
bit-for-bit between the two packages).

The reference computes a 32-bit FNV-1a digest over name+type+tags to shard
metrics onto workers (samplers/parser.go sym: ParseMetric's Digest field,
server.go `Workers[Digest % len(Workers)]`), and a 64-bit hash for HLL
member insertion inside the vendored hyperloglog. We keep FNV-1a exactly
(so a veneur-proxy hashing metrics at us agrees about key identity) and use
64-bit FNV-1a for set members.
"""

from __future__ import annotations

FNV32_OFFSET = 0x811C9DC5
FNV32_PRIME = 0x01000193
FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x00000100000001B3
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_32(data: bytes, h: int = FNV32_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * FNV32_PRIME) & _M32
    return h


def fnv1a_64(data: bytes, h: int = FNV64_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * FNV64_PRIME) & _M64
    return h


def metric_digest(name: str, type_: str, joined_tags: str) -> int:
    """The worker-sharding digest over (name, type, tags) — parity with
    samplers.ParseMetric's fnv32a over the same fields."""
    h = fnv1a_32(name.encode())
    h = fnv1a_32(type_.encode(), h)
    h = fnv1a_32(joined_tags.encode(), h)
    return h


def fmix64(h: int) -> int:
    """murmur3 64-bit finalizer — full-avalanche post-mix."""
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _M64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _M64
    h ^= h >> 33
    return h


def set_member_hash(member: str) -> int:
    """64-bit hash of a set member for HLL insertion.

    FNV-1a alone has weak high-bit avalanche on similar strings (the HLL
    register index is the TOP 14 bits), so the digest is post-mixed with
    the murmur3 finalizer — the reference's vendored sketch likewise uses
    a full-avalanche hash (metro) rather than raw FNV.
    """
    return fmix64(fnv1a_64(member.encode()))
