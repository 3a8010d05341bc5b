"""cryobench: one run of one cell of the benchmark of xmipp3_tpu_torch.

    python3 cryobench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell (`workloads` of BENCHMARK.json)
names a configuration (its file under cryobench/configs/) and a traffic mix
(cryobench/traffic/<mix>.json), whose `job` names the window runner
(cryobench/jobs/<job>.py). Set-up makes the cell's inputs on the card from
the seed and warms every shape a job uses; the window then runs whole jobs
back to back and ends at the first batch end after --seconds, with a
synchronise. A rate is all the particles the window completed over all of
its time. With --trace 1 the same window runs under torch.profiler, with
the benchmark's spans synchronised and the program's phase timing on, and
the per-layer metrics (one reader a metric, cryobench/metrics/<name>.py)
are reported instead of the end-to-end ones.

Once the window has closed, the peak memory has been read and the
program's state is freed, the plain reference (cryobench/reference/)
judges what the window produced against the limits of
cryobench/limits/<workload>.json. The last line of standard output is the
result as one JSON object; the numbers compared are the last lines of
standard error and the result's last key.

Exits 2 without a result when there is no card or fewer cards than the
cell asks for, when the program is not in the checkout, or when a module
of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xmipp3_tpu")
CACHES = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"))


class NoResult(Exception):
    """The run cannot give a result; the message says why."""


def forbidden_modules(names) -> list[str]:
    """The names among `names` whose top-level package (the part before
    the first dot, compared whole) is JAX's or the JAX package's."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc build directory is xmipp3_tpu_torch/_build/)."""
    for var, sub in CACHES:
        os.environ[var] = str(root / ".cryobench_cache" / sub)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell `workload` of root/BENCHMARK.json with its configuration,
    mix, limits and the metrics that apply to it."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    wl = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / "cryobench" / "traffic"
                      / f"{wl['traffic']}.json").read_text())
    lim_path = root / "cryobench" / "limits" / f"{workload}.json"
    limits = json.loads(lim_path.read_text())["limits"] \
        if lim_path.exists() else {}

    def applies(m):
        return workload in m["workloads"] if "workloads" in m else True
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return SimpleNamespace(bench=bench, wl=wl, cfg=cfg, mix=mix,
                           limits=limits, e2e=e2e, layer=layer)


class Spans:
    """The benchmark's host spans. Off (the end-to-end run) they cost
    nothing; on (the traced run) each is synchronised when asked, marked
    for the profiler and its seconds kept by name."""

    def __init__(self, on: bool, dev):
        self.on, self.dev = on, dev
        self.seconds: dict[str, list[float]] = {}

    @contextmanager
    def __call__(self, name: str, sync: bool = False):
        if not self.on:
            yield
            return
        import torch
        from cryobench.trace import SPAN_PREFIX
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            yield
            if sync and self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            self.seconds.setdefault(name, []).append(
                time.perf_counter() - t0)


def window(job, seconds: float, dev, sync) -> tuple[int, float, int]:
    """Whole jobs back to back until the first batch end after `seconds`,
    then a synchronise: (particles completed, seconds, batches)."""
    done = batches = 0
    t0 = time.perf_counter()
    while True:
        done += job.step().particles
        batches += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return done, time.perf_counter() - t0, batches


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(workload: str, seed: int, seconds: float, trace: bool,
        root: Path, device: str = "cuda") -> dict:
    """One run of a cell; returns the result object. device="cpu" is for
    the CPU tests, which drive the rest of a run without a card."""
    cell = load_cell(root, workload)
    chips = int(cell.wl["chips"])
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise NoResult(f"the cell needs {chips} CUDA card(s); "
                       f"torch.cuda.is_available() is "
                       f"{torch.cuda.is_available()}, device_count "
                       f"{torch.cuda.device_count()}")
    from cryobench import check, data as data_mod
    from cryobench.jobs import load
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.ops import cross, scatter_kb

    dev = torch.device(device)
    # the programs compute in full float32: no TF32 in library products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # set-up's parts, each from the end of the one before: the imports
    # with the device query, the card's context, the inputs, the warm-up
    parts = {"import": time.perf_counter() - T_START}
    sync()
    parts["context"] = time.perf_counter() - T_START - parts["import"]
    data = data_mod.make(cell.cfg, seed, dev)
    sync()
    parts["data"] = time.perf_counter() - T_START - sum(parts.values())
    spans = Spans(trace, dev)
    kind = load(cell.mix["job"])
    job = kind.Job(cell.cfg, cell.mix, data, dev, spans, seed)
    job.warm()
    sync()
    setup_s = time.perf_counter() - T_START
    parts["warm"] = setup_s - sum(parts.values())

    if trace:
        cross.launches = scatter_kb.launches = 0
        timing.enable_timing(True)
        timing.take_timing()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    with spans("window"):
        particles, window_s, batches = window(job, seconds, dev, sync)
    result = {"correct": False, "attempted": particles, "failed": 0}
    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                       dev)) if cuda else 0}
    if trace:
        prof.__exit__(None, None, None)
        from cryobench import trace as tr
        phases = timing.take_timing()
        timing.enable_timing(False)
        dev_ops, host, t0_ns, t1_ns = tr.collect(prof)
        busy = tr.busy_ns(dev_ops) * 1e-9
        ctx = SimpleNamespace(
            cfg=cell.cfg, mix=cell.mix, workload=workload, job=job,
            data=data, spans=spans.seconds, phases=phases, dev_ops=dev_ops,
            launches={"cross": cross.launches,
                      "scatter_kb": scatter_kb.launches},
            batches=batches, window_s=window_s, busy_s=busy, dev=dev)
        for m in cell.layer:
            reader = load_module(root / "cryobench" / "metrics"
                                 / f"{m['name']}.py",
                                 f"cryobench_metric_{len(metrics)}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info.update(busy_s=busy, window_s=window_s)
        result["breakdown"] = {
            "device_ops": tr.top_ops(dev_ops),
            "idle_gaps": tr.idle_gaps(dev_ops, host, t0_ns, t1_ns)}
        result["launches"] = ctx.launches
        del prof, dev_ops, host
    else:
        rate = cell.mix["rate_metric"]
        values = {rate: particles / window_s, "setup_s": setup_s}
        for m in cell.e2e:
            if m["name"] not in values:
                raise NoResult(f"the cell reports {m['name']}, which the "
                               f"{cell.mix['job']} job does not measure")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks, failed = check.judge(cell, job, data, seed, dev)
    result.update(correct=check.passed(checks), failed=failed,
                  metrics=metrics, device=device_info)
    result["power"] = power_limit()
    result["setup_parts"] = parts
    result["checks"] = checks
    # last, once everything that prints the result has been loaded
    found = forbidden_modules(sys.modules)
    if found:
        raise NoResult("modules of JAX or of the JAX package were loaded: "
                       + ", ".join(found))
    return result


def find_program(root: Path) -> None:
    """Import the program under test from the checkout, or say why not."""
    try:
        import xmipp3_tpu_torch
    except ImportError as err:
        raise NoResult(f"the program is not in this checkout: {err}")
    where = Path(xmipp3_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise NoResult(f"the program was loaded from {where}, outside the "
                       "checkout")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    set_cache_dirs(root)
    os.environ.setdefault("USE_FLAX", "0")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    if str(HERE.parent) not in sys.path:
        sys.path.insert(0, str(HERE.parent))
    try:
        find_program(root)
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), root)
    except NoResult as why:
        print(f"cryobench: no result: {why}", file=sys.stderr)
        return 2
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in
                              result["setup_parts"].items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
