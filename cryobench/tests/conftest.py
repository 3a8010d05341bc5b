"""CPU tests of the benchmark: a tiny checkout (BENCHMARK.json and data
files made in a temporary directory, the harness's code from here) that
the harness runs on the CPU. Run them with

    python -m pytest cryobench/tests -q

from the repository's root; tests marked `cuda` run only on a card."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"box": 32, "apix": 3.0, "kv": 300}
# limits of the tiny cells: about ten times what sound runs read at N=32
TINY_LIMITS = {
    "match": {"dirs_unmatched": 0.0, "gallery_err": 1e-5, "scan_gap": 1e-5,
              "psi_err_deg": 0.03, "shift_err_px": 1e-3, "corr_err": 3e-5},
    "reconstruct": {"grid_err": 2e-3, "map_err": 3e-6},
}
DUMMY_METRIC = '''"""A metric that exists only in the test's checkout: the window's
batches."""
LAYER = "Test layer"
UNIT, SOURCE, MOVES = "batches", "program_counter", "assign_rate"


def read(ctx):
    return ctx.batches
'''


def make_tiny_root(root: Path) -> Path:
    """A checkout holding only added files: tiny configurations of C1, D2
    and C3 (a symmetry no configuration of the benchmark has), the two
    mixes at small batches, their limits and a dummy per-layer metric;
    the metrics of cryobench/metrics are copied."""
    cb = root / "cryobench"
    for sub in ("configs", "traffic", "limits"):
        (cb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "cryobench" / "metrics", cb / "metrics",
                    dirs_exist_ok=True)
    (cb / "metrics" / "test_batches.py").write_text(DUMMY_METRIC)
    base = json.loads((REPO / "cryobench/configs/pf80s_10028.json")
                      .read_text())
    configs = []
    for sym, blobs in (("c1", 8), ("d2", 3), ("c3", 3)):
        c = dict(base, name=f"tiny_{sym}", particles=64,
                 sizes=dict(TINY, sym=sym),
                 map=dict(extent_A=70, blobs_per_asymmetric_unit=blobs,
                          blob_sigma_px=[1.5, 3.0]))
        (cb / "configs" / f"tiny_{sym}.json").write_text(json.dumps(c))
        configs.append({"name": c["name"], "source": "test",
                        "file": f"cryobench/configs/tiny_{sym}.json",
                        "reduced": [], "why": "test"})
    mixes = {
        "tiny_match": dict(json.loads((REPO / "cryobench/traffic/match.json")
                                      .read_text()), batch=64,
                           check_particles=64, gallery_rate_deg=15),
        "tiny_reconstruct": dict(json.loads(
            (REPO / "cryobench/traffic/reconstruct.json").read_text()),
            batch=64, check_voxels=512)}
    for name, mix in mixes.items():
        (cb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = [f"tiny_{s}.{k}" for s in ("c1", "d2")
             for k in ("match", "reconstruct")] + ["tiny_c3.match"]
    for cell in cells:
        kind = cell.split(".")[1]
        lim = {k: {"limit": v} for k, v in TINY_LIMITS[kind].items()}
        (cb / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))
    match = [c for c in cells if c.endswith("match")]
    rec = [c for c in cells if c.endswith("reconstruct")]
    per_layer = [
        {"name": "test_batches", "unit": "batches", "better": "higher",
         "source": "program_counter", "layer": "Test layer",
         "moves": "assign_rate", "workloads": match},
        {"name": "gallery_s", "unit": "s", "better": "lower",
         "source": "host_clock", "layer": "g", "moves": "assign_rate",
         "workloads": match},
        {"name": "grid_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "g", "moves": "rec_rate",
         "workloads": rec}]
    bench = {
        "command": ["python3", "cryobench/run.py"], "paths": ["cryobench"],
        "run_seconds": 1, "configs": configs,
        "workloads": [{"name": c, "config": c.split(".")[0],
                       "traffic": "tiny_" + c.split(".")[1], "chips": 1,
                       "why": "test"} for c in cells],
        "end_to_end": [
            {"name": "assign_rate", "unit": "particles/s",
             "better": "higher", "bound": 0.05, "source": "host_clock",
             "workloads": match},
            {"name": "rec_rate", "unit": "particles/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": rec},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": per_layer}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
