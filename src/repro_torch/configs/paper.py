"""The paper's own workload config: ChEMBL-scale Tanimoto KNN search."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperSearchConfig:
    name: str = "chembl-27.1"
    n_molecules: int = 1_941_405       # ChEMBL 27.1 (paper §III-B)
    fp_len: int = 1024                 # Morgan-1024
    k: int = 20                        # Top-20 search (paper Table I)
    cutoff: float = 0.8                # similarity cutoff for BitBound (Fig. 10)
    folding_m: int = 4
    folding_scheme: int = 1
    hnsw_m: int = 16
    hnsw_ef_construction: int = 100
    hnsw_ef_search: int = 64
    queries_per_batch: int = 1024


CHEMBL_LIKE = PaperSearchConfig()
