"""Stochastic-rounding keys and the Philox4x32-10 counter stream.

Counterpart of the key handling of ``jax.random`` (``PRNGKey``,
``fold_in``) and of ``codec_pallas.seed_from_key`` in the JAX package, on
plain host integers: deriving a key never touches a device and never
synchronises. The TPU kernels draw their rounding offsets from the chip's
hardware generator; here the kernels of ``csrc/codec.cu`` and the plain
versions in ``ops/`` draw them from one counter-based stream, Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011;
Random123's ``philox4x32_R(10, ...)``), written once in CUDA and once here,
so a kernel and its plain version give the same bytes.

The counter layout of a quantize (``chunk_offsets``):

* key: the 64-bit seed (:func:`seed_from_key`) as two 32-bit words, high
  word first;
* counter: ``(l, c mod 2^32, (c >> 32) mod 2^16 | tag << 16, g)`` for
  position ``l`` of the bucket, chunk index ``c`` and bucket group ``g =
  s // 4`` of the chunk's 32 buckets;
* output word ``j`` of the call rounds bucket ``4g + j``, as ``r = (word >>
  8) * 2^-24`` (:func:`uniform24`, the TPU kernels' conversion), and the
  level is ``floor(q + r)`` clamped.

``c`` counts whole 32-bucket chunks row-major over every row of one
quantize (for an SRA epilogue: over its output row). ``tag`` 0 is the chunk
stream; the dense tail of a row's last ``nb % 32`` buckets draws with
:data:`TAG_TAIL`, chunk index the row, ``g`` over its buckets. So a value's
offset depends on the seed, the row, the chunk, the bucket and the position
alone, and not on how a kernel cuts the work (cluster size, rounds, tiles,
ring depth, pack) or which kernel ran.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Random123).
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10

TAG_CHUNKS = 0  # the counter's stream tag of the chunk kernels' draws
TAG_TAIL = 1  # the dense tail's draws (codec_pallas' fold_in(key, 0x7A11))
_FOLD_WORD = 0x464F4C44  # counter word 2 of fold_in ("FOLD")


@dataclasses.dataclass(frozen=True)
class Key:
    """An explicit, immutable stochastic-rounding key: two 32-bit words."""

    hi: int
    lo: int

    def __post_init__(self):
        if not (0 <= self.hi <= MASK32 and 0 <= self.lo <= MASK32):
            raise ValueError(f"key words must be 32-bit unsigned, got {self.hi}, {self.lo}")


def key(seed: int) -> Key:
    """The key of an integer seed (``jax.random.PRNGKey``): its high and low
    32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return Key(seed >> 32, seed & MASK32)


def _mulhilo(a, m: int):
    """``(hi, lo)`` 32-bit words of ``a * m`` for 32-bit ``a`` (a Python
    int or an int64 tensor) and constant ``m``: the two halves of the
    product mod 2^64, which int64 arithmetic wraps to (a Python int holds
    it exactly). The known-answer vectors of the tests cover products past
    2^63."""
    p = a * m
    return (p >> 32) & MASK32, p & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter ``(c0, c1, c2, c3)`` under key ``(k0,
    k1)``: the four 32-bit output words. The counter words are Python ints
    or int64 tensors of values in [0, 2^32) (broadcast together); the key
    words are ints."""
    for i in range(PHILOX_ROUNDS):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def fold_in(k: Key, data: int) -> Key:
    """A new key from ``k`` and a non-negative integer (``jax.random.fold_in``):
    the first two words of Philox4x32-10 of ``(data mod 2^32, data >> 32
    mod 2^32, "FOLD", 0)`` under ``k``. Pure: every rank derives the same
    key from the same arguments."""
    data = int(data)
    if data < 0:
        raise ValueError(f"fold_in data must be non-negative, got {data}")
    o0, o1, _, _ = philox4x32_10(data & MASK32, (data >> 32) & MASK32, _FOLD_WORD, 0, k.hi, k.lo)
    return Key(o0, o1)


def seed_from_key(k: Key) -> int:
    """The 64-bit seed the kernels take (``codec_pallas.seed_from_key``)."""
    return (k.hi << 32) | k.lo


def seed_words(seed: int) -> Tuple[int, int]:
    """The Philox key words ``(k0, k1)`` of a 64-bit seed."""
    return (seed >> 32) & MASK32, seed & MASK32


def uniform24(word: torch.Tensor) -> torch.Tensor:
    """f32 offsets in [0, 1) from 32-bit words: ``(word >> 8) * 2^-24``,
    exact."""
    return (word >> 8).to(torch.float32) * (2.0**-24)


def chunk_offsets(
    seed: int, chunks: int, bucket_size: int, *, tag: int = TAG_CHUNKS, device=None,
) -> torch.Tensor:
    """f32 rounding offsets ``(chunks * 32, bucket_size)`` of chunk indices
    ``0 .. chunks - 1`` under ``seed``: row ``32*c + s`` is bucket ``s`` of
    chunk ``c``, in the counter layout of the module note."""
    k0, k1 = seed_words(seed)
    l = torch.arange(bucket_size, dtype=torch.int64, device=device).view(1, 1, -1)
    c = torch.arange(chunks, dtype=torch.int64, device=device).view(-1, 1, 1)
    g = torch.arange(8, dtype=torch.int64, device=device).view(1, -1, 1)
    c2 = ((c >> 32) & 0xFFFF) | (tag << 16)
    words = torch.broadcast_tensors(*philox4x32_10(l, c & MASK32, c2, g, k0, k1))  # (chunks, 8, B)
    return uniform24(torch.stack(words, dim=2).reshape(chunks * 32, bucket_size))
