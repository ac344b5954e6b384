"""CUDA kernels vs their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs on a machine with a card and
no JAX: ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
Each test skips where torch sees no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.fingerprints import as_words, popcount, resolve_metric
from repro_torch.data.molecules import SyntheticConfig, synthetic_fingerprints
from repro_torch.kernels import ops, ref

METRICS = ["tanimoto", "dice", "cosine", "tversky(0.7,0.3)"]


def _sorted_db(n, seed):
    db = synthetic_fingerprints(SyntheticConfig(n=n, seed=seed))
    counts = np.bitwise_count(db).sum(-1)
    return db[np.argsort(counts, kind="stable")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_kernels_match_plain_on_card(cuda_device, metric):
    """Both kernels bit-identical to their plain versions at an odd shape."""
    met = resolve_metric(metric)
    db = as_words(_sorted_db(5000, seed=13)[:, :7].copy(), cuda_device)
    cnt = popcount(db)
    qs = db[::500].contiguous()
    ops.reset_launch_counts()
    got = ops.tanimoto_topk(qs, db, 20, db_popcount=cnt, metric=met)
    want = ref.tanimoto_topk_ref(qs, db, 20, cnt, metric=met)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    lo = torch.arange(qs.shape[0], device=cuda_device, dtype=torch.int32) * 300
    hi = lo + 1700
    got = ops.window_topk(qs, db, cnt, lo, hi, 240, max_tiles=4, metric=met)
    want = ops.window_topk(qs.cpu(), db.cpu(), cnt.cpu(), lo.cpu(), hi.cpu(),
                           240, max_tiles=4, metric=met)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu().view(torch.int32), want[1].view(torch.int32))
    assert ops.launch_counts() == {"tanimoto_topk": 1, "window_topk": 1}
