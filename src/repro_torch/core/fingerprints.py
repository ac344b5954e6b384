"""Packed binary molecular fingerprints and bit-vector similarity metrics.

Fingerprints are L-bit binary vectors (paper: L=1024, Morgan radius-2),
packed little-endian into 32-bit words, shape (..., L//32). At the numpy
boundary the words are ``uint32``; inside torch they are carried as
``int32`` bit-views (``arr.view(np.int32)``), because torch on the CPU
cannot shift ``uint32`` tensors and has no popcount op. The plain popcount
below is a SWAR count on 16-bit halves that masks after every shift, so no
intermediate overflows; the CUDA kernels reinterpret the same words as
``uint32`` and use ``__popc``.

Every metric is a function of the popcount triple ``(a=|A|, b=|B|,
c=|A&B|)`` built from exact integers and one correctly rounded f32 divide
(cosine adds one correctly rounded f32 sqrt), so the plain torch path, the
numpy oracle and the kernels agree bit for bit.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

WORD_BITS = 32
DEFAULT_LEN = 1024  # paper: 1024-bit Morgan fingerprint

METRIC_NAMES = ("tanimoto", "dice", "cosine", "tversky")
TVERSKY_SCALE = 256  # tversky weights quantize to this dyadic grid


@dataclass(frozen=True)
class Metric:
    """A bit-vector similarity over the popcount triple (a, b, c).

    * ``tanimoto``  c / (a + b - c)
    * ``dice``      2c / (a + b)
    * ``cosine``    c / sqrt(a * b)
    * ``tversky``   c / (c + alpha*(a - c) + beta*(b - c))

    Frozen and hashable, so a descriptor can key an engine's cache.
    ``alpha``/``beta`` only apply to ``tversky`` and are quantized to the
    1/256 grid (``TVERSKY_SCALE``): the score is then one f32 divide of
    exact integers.
    """
    name: str = "tanimoto"
    alpha: float = 0.0
    beta: float = 0.0

    def __post_init__(self):
        if self.name not in METRIC_NAMES:
            raise ValueError(
                f"unknown metric {self.name!r}; expected one of {METRIC_NAMES}")
        if self.name != "tversky" and (self.alpha or self.beta):
            raise ValueError(
                f"alpha/beta only apply to tversky, not {self.name!r}")
        if self.name == "tversky":
            if self.alpha < 0 or self.beta < 0:
                raise ValueError("tversky alpha/beta must be >= 0")
            if self.alpha > 16 or self.beta > 16:
                raise ValueError("tversky alpha/beta must be <= 16 "
                                 "(integer-exact arithmetic bound)")
            object.__setattr__(
                self, "alpha", round(self.alpha * TVERSKY_SCALE) / TVERSKY_SCALE)
            object.__setattr__(
                self, "beta", round(self.beta * TVERSKY_SCALE) / TVERSKY_SCALE)

    @property
    def spec(self) -> str:
        """Canonical string form, round-trippable via :func:`resolve_metric`."""
        if self.name == "tversky":
            return f"tversky({self.alpha!r},{self.beta!r})"
        return self.name

    @property
    def bounded_below(self) -> bool:
        return self.name != "tversky" or self.alpha > 0

    @property
    def bounded_above(self) -> bool:
        return self.name != "tversky" or self.beta > 0

    @property
    def bounded(self) -> bool:
        """Whether a non-trivial BitBound-style popcount window exists."""
        return self.bounded_below or self.bounded_above

    @property
    def tversky_weights(self) -> tuple[int, int]:
        """The quantized integer weights ``(pa, pb)`` (0, 0 off tversky)."""
        return (int(round(self.alpha * TVERSKY_SCALE)),
                int(round(self.beta * TVERSKY_SCALE)))

    def bound_ratios(self, cutoff: float):
        """Eq.2-style popcount window as multipliers of the query popcount
        ``a``: sim(q, d) >= cutoff requires ``lo * a <= b <= hi * a``.
        Unbounded sides are 0.0 / +inf."""
        sc = max(float(cutoff), 1e-6)
        if self.name == "tanimoto":
            return float(cutoff), 1.0 / sc
        if self.name == "dice":
            return float(cutoff) / (2.0 - float(cutoff)), (2.0 - float(cutoff)) / sc
        if self.name == "cosine":
            return float(cutoff) ** 2, 1.0 / sc**2
        lo = (float(cutoff) * self.alpha
              / max(1.0 - float(cutoff) + float(cutoff) * self.alpha, 1e-9)
              if self.bounded_below else 0.0)
        hi = ((1.0 - float(cutoff) + float(cutoff) * self.beta)
              / max(float(cutoff) * self.beta, 1e-9)
              if self.bounded_above else float("inf"))
        return lo, hi


TANIMOTO = Metric("tanimoto")

_TVERSKY_RE = re.compile(
    r"^tversky\(\s*([0-9.eE+-]+)\s*,\s*([0-9.eE+-]+)\s*\)$")


def resolve_metric(metric) -> Metric:
    """Coerce ``None`` / name string / spec string / Metric to a Metric."""
    if metric is None:
        return TANIMOTO
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str):
        m = _TVERSKY_RE.match(metric)
        if m:
            return Metric("tversky", float(m.group(1)), float(m.group(2)))
        if metric == "tversky":
            return Metric("tversky", 0.5, 0.5)   # Dice-weighted default
        return Metric(metric)
    raise TypeError(f"cannot resolve metric from {metric!r}")


def metric_from_counts(metric: Metric, inter: torch.Tensor,
                       q_cnt: torch.Tensor, d_cnt: torch.Tensor) -> torch.Tensor:
    """Metric on the popcount triple (int32 tensors, broadcastable) -> f32.

    The op sequence is the reference's: exact int32 numerator and
    denominator, one f32 divide, a ``> 0`` guard; cosine is the f32 sqrt of
    the exact ratio ``c^2 / (a*b)``; tversky uses the quantized integer
    weights. torch's f32 ``/`` and ``sqrt`` round correctly on both devices.
    """
    zero = torch.zeros((), dtype=torch.float32, device=inter.device)
    if metric.name == "tanimoto":
        union = q_cnt + d_cnt - inter
        return torch.where(union > 0, inter.float() / union.float(), zero)
    if metric.name == "dice":
        denom = q_cnt + d_cnt
        return torch.where(denom > 0, (2 * inter).float() / denom.float(), zero)
    if metric.name == "cosine":
        prod = q_cnt * d_cnt
        ratio = (inter * inter).float() / torch.clamp(prod, min=1).float()
        # torch's vectorised f32 sqrt on the CPU is not correctly rounded;
        # the f64 sqrt of an f32 value, rounded to f32, is (53 >= 2*24 + 2)
        root = torch.sqrt(ratio.double()).float()
        return torch.where(prod > 0, root, zero)
    pa, pb = metric.tversky_weights
    num = TVERSKY_SCALE * inter
    den = num + pa * (q_cnt - inter) + pb * (d_cnt - inter)
    return torch.where(den > 0, num.float() / den.float(), zero)


def metric_from_counts_np(metric: Metric, inter, q_cnt, d_cnt) -> np.ndarray:
    """Numpy oracle of :func:`metric_from_counts`, returning bit-equal f32."""
    inter = np.asarray(inter, dtype=np.int64)
    q_cnt = np.asarray(q_cnt, dtype=np.int64)
    d_cnt = np.asarray(d_cnt, dtype=np.int64)
    if metric.name == "tanimoto":
        union = q_cnt + d_cnt - inter
        s = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
        return s.astype(np.float32)
    if metric.name == "dice":
        denom = q_cnt + d_cnt
        s = np.where(denom > 0, 2 * inter / np.maximum(denom, 1), 0.0)
        return s.astype(np.float32)
    if metric.name == "cosine":
        prod = q_cnt * d_cnt
        ratio = ((inter * inter).astype(np.float32)
                 / np.maximum(prod, 1).astype(np.float32))
        return np.where(prod > 0, np.sqrt(ratio, dtype=np.float32),
                        np.float32(0.0)).astype(np.float32)
    pa, pb = metric.tversky_weights
    num = TVERSKY_SCALE * inter
    den = num + pa * (q_cnt - inter) + pb * (d_cnt - inter)
    return np.where(den > 0,
                    num.astype(np.float32)
                    / np.maximum(den, 1).astype(np.float32),
                    np.float32(0.0)).astype(np.float32)


def n_words(length: int = DEFAULT_LEN) -> int:
    if length % WORD_BITS != 0:
        raise ValueError(f"fingerprint length {length} must be a multiple of {WORD_BITS}")
    return length // WORD_BITS


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a (..., L) 0/1 array into (..., L//32) uint32 words (little-endian)."""
    bits = np.asarray(bits, dtype=np.uint8)
    L = bits.shape[-1]
    w = n_words(L)
    shaped = bits.reshape(*bits.shape[:-1], w, WORD_BITS).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32))
    return (shaped * weights).sum(axis=-1, dtype=np.uint32)


def unpack_bits(words: np.ndarray, length: int | None = None) -> np.ndarray:
    """Inverse of :func:`pack_bits` -> (..., L) uint8."""
    words = np.asarray(words, dtype=np.uint32)
    L = length or words.shape[-1] * WORD_BITS
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (words[..., :, None] >> shifts) & np.uint32(1)
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)[..., :L].astype(np.uint8)


def as_words(words, device=None) -> torch.Tensor:
    """Packed words -> an int32 bit-view tensor. A ``uint32`` numpy array is
    reinterpreted (not converted); a tensor must already be int32."""
    if isinstance(words, torch.Tensor):
        if words.dtype != torch.int32:
            raise ValueError(f"packed words must be int32 bit-views, got {words.dtype}")
        return words if device is None else words.to(device)
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device or "cpu")


def words_np(words: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> ``uint32`` numpy words (a copy on the host)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    # x in [0, 2^16): every intermediate stays non-negative and < 2^16
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 bit-views -> int32 in [0, 32]."""
    return _popcount16(words & 0xFFFF) + _popcount16((words >> 16) & 0xFFFF)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Number of set bits per fingerprint: (..., W) int32 -> (...,) int32."""
    return popcount_words(words).sum(-1, dtype=torch.int32)


def tanimoto(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tanimoto similarity between packed fingerprints (broadcasting)."""
    return metric_from_counts(TANIMOTO, popcount(a & b), popcount(a), popcount(b))


def tanimoto_scores(query: torch.Tensor, db: torch.Tensor,
                    db_popcount: torch.Tensor | None = None) -> torch.Tensor:
    """Scores of one packed query (W,) against a packed DB (N, W) -> (N,) f32."""
    return metric_scores(query, db, TANIMOTO, db_popcount)


def batched_tanimoto_scores(queries: torch.Tensor, db: torch.Tensor,
                            db_popcount: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, W) x (N, W) -> (Q, N) f32 score matrix."""
    return batched_metric_scores(queries, db, TANIMOTO, db_popcount)


def metric_scores(query: torch.Tensor, db: torch.Tensor, metric: Metric = TANIMOTO,
                  db_popcount: torch.Tensor | None = None) -> torch.Tensor:
    """Metric-generic scores of one query ((W,) x (N, W) -> (N,))."""
    return batched_metric_scores(query[None, :], db, metric, db_popcount)[0]


def intersections(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) -> (Q, N) int32 ``popcount(q & d)``, accumulated one
    word at a time so the largest intermediate is (Q, N)."""
    inter = torch.zeros((queries.shape[0], db.shape[0]), dtype=torch.int32,
                        device=db.device)
    for w in range(db.shape[1]):
        inter += popcount_words(queries[:, w, None] & db[None, :, w])
    return inter


def batched_metric_scores(queries: torch.Tensor, db: torch.Tensor,
                          metric: Metric = TANIMOTO,
                          db_popcount: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, W) x (N, W) -> (Q, N) f32 under ``metric``."""
    if db_popcount is None:
        db_popcount = popcount(db)
    inter = intersections(queries, db)
    return metric_from_counts(metric, inter, popcount(queries)[:, None],
                              db_popcount.to(torch.int32)[None, :])


def batched_metric_scores_np(queries: np.ndarray, db: np.ndarray,
                             metric: Metric = TANIMOTO,
                             db_popcount: np.ndarray | None = None
                             ) -> np.ndarray:
    """Host oracle: (Q, W) x (N, W) uint32 -> (Q, N) f32, bit-equal to the
    torch and kernel paths."""
    queries = np.asarray(queries)
    db = np.asarray(db)
    if db_popcount is None:
        db_popcount = np.bitwise_count(db).sum(-1, dtype=np.int64)
    q_cnt = np.bitwise_count(queries).sum(-1, dtype=np.int64)
    inter = np.bitwise_count(queries[:, None, :] & db[None, :, :]).sum(
        -1, dtype=np.int64)
    return metric_from_counts_np(metric, inter, q_cnt[:, None],
                                 np.asarray(db_popcount, np.int64)[None, :])
