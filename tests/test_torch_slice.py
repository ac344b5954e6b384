"""The port's slice as a whole: the same seeds through both packages' entry
points, the serving loop end to end, the import boundary, and the chip
smoke's refusal to run without a card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs import CHEMBL_LIKE as R_CHEMBL
from repro.core import BitBoundFoldingEngine as RBitBound
from repro.core import BruteForceEngine as RBrute
from repro.data import molecules as rmol
from repro_torch.configs import CHEMBL_LIKE
from repro_torch.core import BitBoundFoldingEngine, BruteForceEngine
from repro_torch.data import molecules as pmol
from repro_torch.launch.search_serve import main as serve_main, serve

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_paper_config_is_the_reference_config():
    assert CHEMBL_LIKE.__dict__ == R_CHEMBL.__dict__
    assert CHEMBL_LIKE.n_molecules == 1_941_405 and CHEMBL_LIKE.k == 20


def test_slice_end_to_end_same_seed_both_packages():
    """Each package generates its own data from the same seed, builds both
    engines and serves the same queries: identical bytes in, identical ids
    and f32 scores out, through an insert."""
    cfg = dict(n=1200, seed=3)
    rdb = rmol.synthetic_fingerprints(rmol.SyntheticConfig(**cfg))
    pdb = pmol.synthetic_fingerprints(pmol.SyntheticConfig(**cfg))
    assert rdb.tobytes() == pdb.tobytes()
    rq, pq = rmol.queries_from_db(rdb, 12, seed=1), pmol.queries_from_db(pdb, 12, seed=1)
    extra = pmol.synthetic_fingerprints(pmol.SyntheticConfig(n=40, seed=9))
    kw = dict(cutoff=CHEMBL_LIKE.cutoff, m=CHEMBL_LIKE.folding_m,
              scheme=CHEMBL_LIKE.folding_scheme)
    pairs = [(RBrute(rdb, backend="tpu"), BruteForceEngine(pdb, device="cpu")),
             (RBitBound(rdb, backend="tpu", **kw),
              BitBoundFoldingEngine(pdb, backend="cuda", device="cpu", **kw))]
    for ref, port in pairs:
        for phase in range(2):
            ri, rs = (np.asarray(x) for x in ref.search(rq, CHEMBL_LIKE.k))
            pi, ps = port.search(pq, CHEMBL_LIKE.k)
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(ps.view(np.int32),
                                          rs.astype(np.float32).view(np.int32))
            if phase == 0:
                np.testing.assert_array_equal(port.insert(extra), ref.insert(extra))


def test_serve_end_to_end_on_2000_rows(capsys):
    logs = []
    for engine, backend in (("brute", "cuda"), ("bitbound-folding", "cuda"),
                            ("bitbound-folding", "numpy")):
        qps = serve(engine, n_db=2000, n_queries=16, batches=2,
                    backend=backend, device="cpu", log=logs.append)
        assert qps > 0
    assert len(logs) == 3 and all("QPS" in line for line in logs)
    serve_main(["--engine", "brute", "--n-db", "600", "--n-queries", "4",
                "--batches", "1", "--device", "cpu", "--metric", "dice"])
    assert "metric=dice" in capsys.readouterr().out
    with pytest.raises(ValueError):
        serve("hnsw", n_db=100, device="cpu")
    with pytest.raises(ValueError, match="brute"):
        serve("brute", n_db=100, backend="numpy", device="cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_reference():
    """A process that imports the port and searches loads no ``jax*`` and
    no ``repro.*`` module."""
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.core import BitBoundFoldingEngine, BruteForceEngine\n"
        "from repro_torch.data.molecules import SyntheticConfig, synthetic_fingerprints\n"
        "from repro_torch.launch import search_serve\n"
        "from repro_torch.serve import state\n"
        "from repro_torch.kernels import _build, ops, ref\n"
        "db = synthetic_fingerprints(SyntheticConfig(n=300, seed=1))\n"
        "BruteForceEngine(db, device='cpu').search(db[:2], 5)\n"
        "BitBoundFoldingEngine(db, backend='cuda', device='cpu').search(db[:2], 5)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_import_no_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {name}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke exits non-zero and prints no result; alone in
    a directory (no port beside it) it fails the same way."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        env = _env()
        env.pop("PYTHONPATH")
        env["CUDA_VISIBLE_DEVICES"] = ""
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, env=env,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
        for line in out.stdout.splitlines():
            with pytest.raises(json.JSONDecodeError):
                json.loads(line)
