"""Port kernel wrappers vs the reference's Pallas wrappers (interpret mode).

On the CPU each port wrapper runs its kernel's plain version, so these
tests pin the semantics the CUDA kernels are held to on the card: the
exact top-k by (score desc, row asc), -1 / -inf in empty slots, the
``n_valid`` mask, the per-query row windows and the silent ``max_tiles``
truncation. Ids and f32 scores must be bit-identical. The kernels
themselves are held against these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitbound as rbb
from repro.core import folding as rfl
from repro.core.fingerprints import popcount as rpopcount, resolve_metric as rres
from repro.data.molecules import SyntheticConfig, queries_from_db, synthetic_fingerprints
from repro.kernels import ops as rops
from repro_torch.core.fingerprints import as_words, popcount, resolve_metric
from repro_torch.kernels import ops

def _db(n, seed=0, length=1024):
    return synthetic_fingerprints(SyntheticConfig(n=n, seed=seed, length=length))


def _sorted_db(n, seed):
    db = _db(n, seed=seed)
    counts = np.bitwise_count(db).sum(-1)
    return db[np.argsort(counts, kind="stable")]


def _same(got, want):
    gi, gv = (t.numpy() for t in got)
    wi, wv = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))


@pytest.mark.parametrize("n,q,k,tile,metric", [
    (1000, 3, 5, 128, "tanimoto"),
    (300, 2, 10, 128, "dice"),          # padded final tile
    (130, 2, 64, 128, "cosine"),        # k close to n
    (90, 2, 120, None, "tversky(0.7,0.3)"),   # k > n: -1 / -inf tail
])
def test_tanimoto_topk_matches_reference(n, q, k, tile, metric):
    db = _db(n, seed=1)
    db[5] = db[6]                       # an exact tie between two rows
    qs = np.concatenate([db[5:6], queries_from_db(db, q - 1, seed=2)])
    want = rops.tanimoto_topk(jnp.asarray(qs), jnp.asarray(db), k=k, tile_n=tile,
                              metric=rres(metric))
    got = ops.tanimoto_topk(as_words(qs), as_words(db), k, tile_n=tile,
                            metric=resolve_metric(metric))
    _same(got, want)
    assert got[0][0, 0] == 5 and got[0][0, 1] == 6   # ties: lowest row first
    if k > n:
        assert (got[0][:, n:] == -1).all() and torch.isinf(got[1][:, n:]).all()


def test_tanimoto_topk_folded_words():
    """Folded databases have fewer words (W=8 at m=4, W=7 odd)."""
    db = _db(700, seed=3)
    for m, words in ((4, None), (1, 7)):
        d = rfl.fold(db, m, 1) if words is None else db[:, :words].copy()
        qs = d[[10, 20, 30]]
        want = rops.tanimoto_topk(jnp.asarray(qs), jnp.asarray(d), k=9, tile_n=128)
        _same(ops.tanimoto_topk(as_words(qs), as_words(d), 9), want)


@pytest.mark.parametrize("metric", ["tanimoto", "tversky(0.7,0.3)"])
def test_window_topk_matches_reference(metric):
    """Per-query windows incl. empty, tiny, full-DB and tail windows."""
    db = _sorted_db(3000, seed=3)
    qs = queries_from_db(db, 5, seed=4)
    cnt = np.bitwise_count(db).sum(-1).astype(np.int32)
    lo = np.array([100, 500, 700, 0, 2999], np.int32)
    hi = np.array([2500, 500, 705, 3000, 3000], np.int32)
    want = rops.window_topk(jnp.asarray(qs), jnp.asarray(db), jnp.asarray(cnt),
                            jnp.asarray(lo), jnp.asarray(hi), k=10, tile_n=256,
                            metric=rres(metric))
    got = ops.window_topk(as_words(qs), as_words(db), torch.from_numpy(cnt),
                          torch.from_numpy(lo), torch.from_numpy(hi), k=10,
                          tile_n=256, metric=resolve_metric(metric))
    _same(got, want)
    assert (got[0][1] == -1).all()                      # empty window


def test_window_topk_restricted_max_tiles_truncates():
    """``max_tiles`` below a window's span truncates it silently, exactly as
    the reference does: rows past the first max_tiles tiles never score."""
    db = _sorted_db(4096, seed=9)
    qs = queries_from_db(db, 3, seed=5)
    cnt = np.bitwise_count(db).sum(-1).astype(np.int32)
    lo = np.array([0, 1000, 3000], np.int32)
    hi = np.array([900, 2000, 4096], np.int32)
    for max_tiles in (5, 2):
        want = rops.window_topk(jnp.asarray(qs), jnp.asarray(db),
                                jnp.asarray(cnt), jnp.asarray(lo),
                                jnp.asarray(hi), k=7, tile_n=256,
                                max_tiles=max_tiles)
        got = ops.window_topk(as_words(qs), as_words(db), torch.from_numpy(cnt),
                              torch.from_numpy(lo), torch.from_numpy(hi), k=7,
                              tile_n=256, max_tiles=max_tiles)
        _same(got, want)
    # at max_tiles=2 the third window (3000..4096, 5 tiles) ends at row 3328
    ids = got[0].numpy()
    assert (ids[2][ids[2] >= 0] < (3000 // 256 + 2) * 256).all()


def test_window_topk_folded_db_full_bounds():
    """The two-stage wiring: bounds from full-resolution popcounts, scores
    on the folded DB with folded counts; k larger than the windows."""
    db = _sorted_db(2000, seed=10)
    folded = rfl.fold(db, 4, 1)
    qs = rfl.fold(queries_from_db(db, 3, seed=6), 4, 1)
    fcnt = np.asarray(rpopcount(jnp.asarray(folded)))
    lo = np.array([0, 600, 1990], np.int32)
    hi = np.array([500, 1400, 2000], np.int32)
    want = rops.window_topk(jnp.asarray(qs), jnp.asarray(folded),
                            jnp.asarray(fcnt), jnp.asarray(lo), jnp.asarray(hi),
                            k=24, tile_n=128)
    got = ops.window_topk(as_words(qs), as_words(folded), torch.from_numpy(np.array(fcnt)),
                          torch.from_numpy(lo), torch.from_numpy(hi), k=24,
                          tile_n=128)
    _same(got, want)
    assert (got[0][2, 10:] == -1).all()                  # 10-row window


def test_pick_tile_and_bucket_cover_windows():
    for n in (1, 100, 128, 129, 3000, 2**21):
        assert ops._pick_tile(n, None) == rops._pick_tile(n, None)
    # the engine's bucket always covers the batch's largest window
    counts = np.sort(np.bitwise_count(_db(5000, seed=11)).sum(-1))
    tile = ops._pick_tile(counts.shape[0], None)
    total = -(-counts.shape[0] // tile)
    for cutoff in (0.3, 0.8, 0.95):
        lo, hi = rbb.bound_range_np(counts, np.arange(0, 200), cutoff)
        n_tiles = np.where(hi > lo, (hi + tile - 1) // tile - lo // tile, 0)
        assert rbb.bucket_tiles(int(n_tiles.max()), total) >= n_tiles.max()


def test_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers run the plain version and count nothing."""
    ops.reset_launch_counts()
    db = as_words(_db(200, seed=12))
    ops.tanimoto_topk(db[:2], db, 3)
    ops.window_topk(db[:2], db, popcount(db), torch.tensor([0, 5]),
                    torch.tensor([50, 9]), 3)
    assert ops.launch_counts() == {"tanimoto_topk": 0, "window_topk": 0}
    with pytest.raises(ValueError):
        ops.tanimoto_topk(db[:2].to(torch.int64), db, 3)
