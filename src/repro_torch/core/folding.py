"""Modulo-OR compression ("folding") — paper §III-B, Fig. 3, Table I.

For an L-bit fingerprint and folding level m (power of two):

* **Scheme 1** (strided): OR the m word-sections of L/m bits together.
* **Scheme 2** (adjacent): OR every m neighbouring bits.

Two-stage search: stage 1 scans the m-folded DB and keeps
``k_r1 = k * m * log2(2m)`` candidates; stage 2 rescores them at full
resolution. The numpy folds build the stored database; :func:`fold_torch`
folds queries on the engine's device, value-identical to :func:`fold`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .fingerprints import WORD_BITS, pack_bits, unpack_bits


def kr1_for(k: int, m: int) -> int:
    """Paper: k_r1 = k * m * log2(2m)."""
    if m <= 1:
        return k
    return int(k * m * math.log2(2 * m))


def folded_words(W: int, m: int) -> int:
    """Folded word count for scheme 1: ceil(W / m) (zero-padded sections)."""
    return -(-int(W) // int(m))


def fold_scheme1(words: np.ndarray, m: int, length: int = None) -> np.ndarray:
    """Strided modulo-OR fold of packed prints: (..., W) -> (..., ceil(W/m))."""
    words = np.asarray(words)
    W = words.shape[-1]
    sec = folded_words(W, m)
    if sec * m != W:
        pad = np.zeros((*words.shape[:-1], sec * m - W), dtype=words.dtype)
        words = np.concatenate([words, pad], axis=-1)
    out = words.reshape(*words.shape[:-1], m, sec)
    result = out[..., 0, :]
    for i in range(1, m):
        result = result | out[..., i, :]
    return result


def fold_scheme2(words: np.ndarray, m: int) -> np.ndarray:
    """Adjacent-OR fold: unpack, OR every m neighbouring bits, repack."""
    bits = unpack_bits(words)
    L = bits.shape[-1]
    Lp = -(-L // (m * WORD_BITS)) * (m * WORD_BITS)
    if Lp != L:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], Lp - L), dtype=bits.dtype)],
            axis=-1)
    grouped = bits.reshape(*bits.shape[:-1], Lp // m, m)
    folded = grouped.max(axis=-1)
    return pack_bits(folded)


def fold(words: np.ndarray, m: int, scheme: int = 1) -> np.ndarray:
    if m == 1:
        return np.asarray(words)
    if scheme == 1:
        return fold_scheme1(words, m)
    if scheme == 2:
        return fold_scheme2(words, m)
    raise ValueError(f"unknown folding scheme {scheme}")


def fold_scheme1_torch(words: torch.Tensor, m: int) -> torch.Tensor:
    """Word-level scheme-1 fold of int32 bit-views, value-identical to
    :func:`fold_scheme1` (including the odd-width zero padding)."""
    W = words.shape[-1]
    sec = folded_words(W, m)
    if sec * m != W:
        words = torch.nn.functional.pad(words, (0, sec * m - W))
    sections = words.reshape(*words.shape[:-1], m, sec)
    out = sections[..., 0, :]
    for i in range(1, m):
        out = out | sections[..., i, :]
    return out.contiguous()


def fold_scheme2_torch(words: torch.Tensor, m: int) -> torch.Tensor:
    """Bit-level adjacent-OR fold of int32 bit-views, value-identical to
    :func:`fold_scheme2`. The shifts mask after shifting, and the repack
    sums in int64 so bit 31 does not overflow."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1                 # (..., W, 32)
    L = words.shape[-1] * WORD_BITS
    bits = bits.reshape(*words.shape[:-1], L)
    Lp = -(-L // (m * WORD_BITS)) * (m * WORD_BITS)
    if Lp != L:
        bits = torch.nn.functional.pad(bits, (0, Lp - L))
    folded = bits.reshape(*words.shape[:-1], Lp // m, m).amax(dim=-1)
    out_bits = folded.reshape(*words.shape[:-1], Lp // m // WORD_BITS,
                              WORD_BITS).to(torch.int64)
    packed = (out_bits << shifts.to(torch.int64)).sum(-1)       # [0, 2^32)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def fold_torch(words: torch.Tensor, m: int, scheme: int = 1) -> torch.Tensor:
    """:func:`fold` on int32 bit-view tensors (both schemes), on their device."""
    if m == 1:
        return words
    if scheme == 1:
        return fold_scheme1_torch(words, m)
    if scheme == 2:
        return fold_scheme2_torch(words, m)
    raise ValueError(f"unknown folding scheme {scheme}")
