"""Similarity-search serving loop for the exhaustive engines.

``--engine brute|bitbound-folding`` builds the engine over a synthetic
ChEMBL-like database and answers ``--batches`` batches of
``--n-queries`` queries, after one warm-up pass over every batch, and
reports queries per second. Both engines run their device path on
``--device`` (default ``cuda``); ``--backend numpy`` runs the BitBound
engine's host reference instead.

    PYTHONPATH=src python -m repro_torch.launch.search_serve \\
        --engine bitbound-folding --backend cuda
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import CHEMBL_LIKE
from ..core import BitBoundFoldingEngine, BruteForceEngine
from ..core.fingerprints import resolve_metric
from ..data.molecules import SyntheticConfig, queries_from_db, synthetic_fingerprints


def serve(engine: str = "bitbound-folding", n_db: int = 100_000, k: int = 20,
          n_queries: int = 256, batches: int = 4, backend: str = "cuda",
          device: str = "cuda", metric: str | None = None,
          fp_bits: int | None = None, log=print) -> float:
    """Serve ``batches`` query batches on one engine; returns QPS."""
    if engine not in ("brute", "bitbound-folding"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "brute" and backend != "cuda":
        raise ValueError("the brute-force engine has only the device path "
                         "(backend='cuda')")
    met = resolve_metric(metric)
    length = int(fp_bits) if fp_bits else 1024
    db = synthetic_fingerprints(SyntheticConfig(n=n_db, length=length))
    queries = queries_from_db(db, n_queries * batches)
    if engine == "brute":
        eng = BruteForceEngine(db, metric=met, device=device)
    else:
        eng = BitBoundFoldingEngine(db, cutoff=CHEMBL_LIKE.cutoff,
                                    m=CHEMBL_LIKE.folding_m,
                                    scheme=CHEMBL_LIKE.folding_scheme,
                                    backend=backend, metric=met, device=device)
    batch = [queries[b * n_queries:(b + 1) * n_queries] for b in range(batches)]
    if backend == "cuda":
        for qb in batch:          # warm-up: kernel build, uploads, caches
            eng.search(qb, k)
    t0 = time.perf_counter()
    for qb in batch:
        eng.search(qb, k)         # returns numpy: the device has finished
    dt = time.perf_counter() - t0
    qps = n_queries * batches / dt
    where = (torch.cuda.get_device_name(eng.device)
             if backend == "cuda" and eng.device.type == "cuda"
             else "host")
    log(f"[search-serve] engine={engine} backend={backend} "
        f"device={eng.device} ({where}) metric={met.spec} fp_bits={length} "
        f"db={n_db} k={k}: {qps:.1f} QPS ({dt:.3f}s for "
        f"{n_queries * batches} queries), scanned/query="
        f"{eng.scanned(1)}")
    return qps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="bitbound-folding",
                    choices=["brute", "bitbound-folding"])
    ap.add_argument("--n-db", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--n-queries", type=int, default=256)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "numpy"],
                    help="bitbound-folding execution path: the device path "
                         "(cuda) or the host reference (numpy); brute force "
                         "has only cuda")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device path (cuda or cpu)")
    ap.add_argument("--metric", default=None,
                    help="tanimoto (default), dice, cosine or tversky(a,b)")
    ap.add_argument("--fp-bits", type=int, default=None,
                    help="fingerprint width in bits (multiple of 32)")
    args = ap.parse_args(argv)
    serve(args.engine, n_db=args.n_db, k=args.k, n_queries=args.n_queries,
          batches=args.batches, backend=args.backend, device=args.device,
          metric=args.metric, fp_bits=args.fp_bits)


if __name__ == "__main__":
    main()
