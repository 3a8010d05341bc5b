"""The harness on the CPU: a cell, a mix and a metric that exist only as
added files run; the result's keys; the checks on the checkout and on the
modules loaded."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cryobench import run
from cryobench.tests.conftest import REPO

SEED = 2 ** 33 + 17          # larger than 32 signed bits hold


@pytest.mark.parametrize("cell", ["tiny_c1.match", "tiny_d2.reconstruct",
                                  "tiny_c3.match"])
def test_added_files_make_a_cell_that_runs(tiny_root, cell):
    res = run.run(cell, SEED, 1.5, False, tiny_root, device="cpu")
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    for key in ("metrics", "device"):
        assert key in res
    assert list(res)[-1] == "checks"
    rate = "assign_rate" if cell.endswith("match") else "rec_rate"
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["metrics"][rate]["unit"] == "particles/s"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"], res["checks"]
    json.dumps(res)


def test_added_metric_is_read_in_the_traced_run(tiny_root):
    res = run.run("tiny_c1.match", SEED, 1.0, True, tiny_root, device="cpu")
    assert res["metrics"]["test_batches"]["value"] >= 1
    assert res["metrics"]["gallery_s"]["unit"] == "s"
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("names, found", [
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "xmipp3_tpu",
      "xmipp3_tpu.ops.match"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "xmipp3_tpu",
      "xmipp3_tpu.ops.match"]),
    (["xmipp3_tpu_torch", "xmipp3_tpu_torch.ops.match", "jaxtyping",
      "flaxen", "torch", "xmipp3_tpux"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


IMPORTS = {
    "reference": ("import cryobench.data, cryobench.reference.dft, "
                  "cryobench.reference.match, "
                  "cryobench.reference.reconstruct"),
    "harness": ("import cryobench.run, cryobench.check, cryobench.control, "
                "cryobench.roofline, cryobench.trace, cryobench.jobs.match, "
                "cryobench.jobs.reconstruct, cryobench.judges.match, "
                "cryobench.judges.reconstruct, xmipp3_tpu_torch.ops.match, "
                "xmipp3_tpu_torch.ops.reconstruct, "
                "xmipp3_tpu_torch.ops.project, xmipp3_tpu_torch.ops.ctf, "
                "xmipp3_tpu_torch.core.sampling, "
                "xmipp3_tpu_torch.core.timing"),
}


@pytest.mark.parametrize("what", sorted(IMPORTS))
def test_modules_loaded(what):
    """The reference loads nothing of the program and nothing of JAX; the
    harness with the program's modules it drives loads nothing of JAX or of
    the JAX package."""
    code = (f"import sys; {IMPORTS[what]}\n"
            "import json; print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert run.forbidden_modules(mods) == []
    if what == "reference":
        assert not [m for m in mods if m.split(".")[0] == "xmipp3_tpu_torch"]


@pytest.mark.parametrize("where", ["judge", "power"])
def test_a_module_loaded_by_the_check_gives_no_result(tiny_root, monkeypatch,
                                                      capsys, where):
    """`jax` loaded by the code that decides `correct`, or by the reading
    of the card's power limit, after the window: exit 2 and no result."""
    import types
    from cryobench import check
    real_run, real_judge = run.run, check.judge

    def plant():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    def judge(*a, **kw):
        if where == "judge":
            plant()
        return real_judge(*a, **kw)

    def power():
        plant()
        return None
    monkeypatch.setattr(check, "judge", judge)
    monkeypatch.setattr(run, "power_limit", power)
    monkeypatch.setattr(run, "run", lambda *a, **kw: real_run(
        *a, **dict(kw, device="cpu")))
    monkeypatch.setattr(run, "find_program", lambda root: None)
    monkeypatch.setattr(run, "set_cache_dirs", lambda root: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("USE_FLAX", "0")
    monkeypatch.chdir(tiny_root)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    code = run.main(["--workload", "tiny_c1.match", "--seed", str(SEED),
                     "--seconds", "0.5", "--trace", "0"])
    out = capsys.readouterr()
    assert code == 2
    assert out.out.strip() == ""
    assert "jax" in out.err


def _command(root: Path, *extra):
    return subprocess.run(
        [sys.executable, "cryobench/run.py", "--workload",
         "pf80s_10028.match", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0", *extra], capture_output=True, text=True, cwd=root,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and cryobench/: exit 2 and no
    result line (no card here; with a card, no program)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "cryobench", tmp_path / "cryobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_no_card_gives_no_result():
    """In the repository, without a card: exit 2 and no result line."""
    out = _command(REPO)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()
    for w in bench["workloads"]:
        assert (REPO / "cryobench/traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "cryobench/limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        path = REPO / "cryobench/metrics" / f"{m['name']}.py"
        text = path.read_text()
        assert f'"{m["moves"]}"' in text and f'"{m["source"]}"' in text
