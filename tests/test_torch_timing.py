"""The port's spans and counters (core/timing.py): parents and self time,
counters, the cost when off, the key convention of take_timing, the spans
inside gridding on the CPU, the CLI's report and trace, and the benchmark's
readers of the new per-layer metrics (cryobench/metrics)."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_common import phantom_batch
from xmipp3_tpu_torch.core import timing
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.reconstruct import FourierReconstructor

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def timing_on():
    timing.take_timing()
    timing.enable_timing(True)
    yield
    timing.enable_timing(False)
    timing.take_timing()


def _report_row(report: str, name: str) -> list[str]:
    return next(line.split() for line in report.splitlines()
                if line.split()[:1] == [name])


def test_nested_spans_record_parent_and_self_time(timing_on):
    with timing.timed_phase("outer"):
        time.sleep(0.03)
        with timing.timed_phase("inner"):
            time.sleep(0.06)
    outer = timing.top_level_s()
    report = timing.timing_report()
    took = timing.take_timing()
    # the inner span has a parent, so only the outer one is top level
    assert outer == took["outer"][0]
    assert took["inner"][0] < took["outer"][0]
    host, self_s = map(float, _report_row(report, "outer")[1:3])
    assert host == pytest.approx(took["outer"][0], abs=1e-3)
    assert self_s == pytest.approx(took["outer"][0] - took["inner"][0],
                                   abs=2e-3)
    assert 0.025 <= self_s < 0.06
    inner = _report_row(report, "inner")
    assert float(inner[1]) == float(inner[2])       # no children
    assert inner[3] == "-"                          # no device time here


def test_top_level_spans_sum_once(timing_on):
    for _ in range(2):
        with timing.timed_phase("a"):
            with timing.timed_phase("b"):
                with timing.timed_phase("c"):
                    pass
    with timing.timed_phase("d"):
        pass
    top = timing.top_level_s()
    took = timing.take_timing()
    assert top == pytest.approx(took["a"][0] + took["d"][0])
    assert timing.top_level_s() == 0.0


def test_counters_sum_and_take_clears(timing_on):
    timing.count("things", 3)
    timing.count("things", 4)
    with timing.timed_phase("span"):
        timing.count("things", 5)
    report = timing.timing_report()
    took = timing.take_timing()
    assert took["count:things"] == (12, 3)
    assert took["span"][1] == 1
    assert "-- counters --" in report and "things" in report
    assert timing.take_timing() == {}
    assert timing.timing_report() == ""


def test_spans_off_record_nothing_and_enter_no_profiler_range(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with timing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    timing.take_timing()
    timing.enable_timing(False)
    with timing.timed_phase("hidden", sync=torch.ones(2)):
        with timing.timed_phase("nested"):
            timing.count("hidden", 7)
    assert timing.take_timing() == {}
    assert timing.top_level_s() == 0.0
    assert getattr(timing._LOCAL, "stack", []) == []


def test_spans_on_enter_the_profiler_range(monkeypatch, timing_on):
    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with timing.timed_phase("seen"):
        pass
    assert entered == ["xmipp/seen"]


def test_plain_span_keeps_its_seconds_and_calls(timing_on):
    for _ in range(3):
        with timing.timed_phase("plain", sync=torch.ones(3)):
            torch.ones(8).sum()
    took = timing.take_timing()
    assert set(took) == {"plain"}             # no device key on the CPU
    secs, calls = took["plain"]
    assert type(secs) is float and calls == 3 and secs >= 0


def test_trace_turns_spans_on_and_restores_the_state(tmp_path):
    timing.take_timing()
    timing.enable_timing(False)
    with timing.trace(str(tmp_path / "off")):
        assert timing.timing_enabled()
        with timing.timed_phase("traced"):
            pass
    assert not timing.timing_enabled()
    assert timing.take_timing()["traced"][1] == 1
    timing.enable_timing(True)
    try:
        with timing.trace(str(tmp_path / "on")):
            pass
        assert timing.timing_enabled()
    finally:
        timing.enable_timing(False)
        timing.take_timing()


def test_trace_alone_does_not_synchronise_the_sync_phases(monkeypatch,
                                                          tmp_path):
    """`sync=` synchronises only with timing on by enable_timing (-v 2):
    under `trace` alone the run is queued as an untimed run queues it."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    on_card = SimpleNamespace(is_cuda=True, device="cuda:0")
    timing.take_timing()
    timing.enable_timing(False)
    with timing.trace(str(tmp_path / "alone")):
        with timing.timed_phase("queued", sync=on_card):
            pass
    assert synced == []
    timing.enable_timing(True)
    try:
        with timing.timed_phase("timed", sync=on_card):
            pass
        assert synced == ["cuda:0"]
        with timing.trace(str(tmp_path / "timed")):
            with timing.timed_phase("timed", sync=on_card):
                pass
        assert synced == ["cuda:0"] * 2
    finally:
        timing.enable_timing(False)
    took = timing.take_timing()
    assert took["queued"][1] == 1 and took["timed"][1] == 2


def _kept_samples(n: int, max_freq: float = 0.5) -> int:
    """rfft2 samples of an n x n image within max_freq (cycles/px)."""
    fy, fx = np.fft.fftfreq(n), np.fft.rfftfreq(n)
    return int((np.hypot(fy[:, None], fx[None, :]) <= max_freq).sum())


def test_gridding_spans_and_samples_on_the_cpu(tmp_path):
    N, C = 32, 6
    b = phantom_batch(5, C, N)
    rec = FourierReconstructor(N, 2.0, "d2", 0.5, interp="kb", device="cpu")
    timing.take_timing()
    with timing.trace(str(tmp_path)):
        rec.add_batch(b["imgs"], b["rot"], b["tilt"], b["psi"], b["sx"],
                      b["sy"])
    took = timing.take_timing()
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"xmipp/grid", "xmipp/grid.spectra", "xmipp/grid.coords"} <= names
    assert took["count:k3.samples"] == (C * 4 * _kept_samples(N), 4)
    assert took["grid"][1] == 1
    assert took["grid.spectra"][1] == took["grid.coords"][1] == 4
    assert not [k for k in took if k.startswith("device:")]


def _dataset(tmp_path, N=32, C=8):
    b = phantom_batch(11, C, N)
    stk = str(tmp_path / "parts.mrcs")
    save_image(stk, b["imgs"])
    fn = str(tmp_path / "parts.xmd")
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(b["rot"][i]),
         "angleTilt": float(b["tilt"][i]), "anglePsi": float(b["psi"][i])}
        for i in range(C)).write(fn)
    return fn


def test_cli_trace_names_the_program_spans(tmp_path):
    from xmipp3_tpu_torch.programs import get_program
    fn = _dataset(tmp_path)
    timing.take_timing()
    rc = get_program("reconstruct_fourier").run_with_args(
        ["-i", fn, "-o", str(tmp_path / "rec.vol"), "--device", "cpu",
         "--trace", str(tmp_path / "tr")])
    assert rc == 0
    assert not timing.timing_enabled()
    timing.take_timing()
    text = (tmp_path / "tr" / "trace.json").read_text()
    for span in ("xmipp/grid", "xmipp/grid.spectra", "xmipp/finalize"):
        assert span in text


def test_cli_verbose_prints_the_report_with_self_and_device(tmp_path):
    fn = _dataset(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "xmipp3_tpu_torch.programs",
         "reconstruct_fourier", "-i", fn, "-o", str(tmp_path / "rec.vol"),
         "--device", "cpu", "-v", "2"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "-- phase timing --" in out.stdout
    header = next(line for line in out.stdout.splitlines()
                  if "self s" in line)
    assert header.split() == ["span", "host", "s", "self", "s", "device",
                              "s", "calls", "ms/call"]
    assert "-- counters --" in out.stdout and "k3.samples" in out.stdout


def test_no_environment_switch_left():
    for path in (REPO / "xmipp3_tpu_torch").rglob("*.py"):
        assert "XMIPP_TIMING" not in path.read_text(), path


# the benchmark's readers of the new per-layer metrics: (phases, expected)
PHASES = {
    "project.volume": (0.5, 2), "device:project.volume": (0.04, 2),
    "project.slices": (0.9, 20), "device:project.slices": (0.26, 20),
    "scan": (1.0, 4), "device:match.peaks": (0.12, 104),
    "grid": (0.08, 2), "device:grid": (0.09, 2),
    "grid.ctf": (0.001, 2), "device:grid.ctf": (0.002, 2),
    "grid.spectra": (0.01, 8), "device:grid.spectra": (0.004, 8),
    "grid.coords": (0.01, 8), "device:grid.coords": (0.002, 8),
    "count:k3.samples": (50_000_000, 8),
    "finalize": (0.001, 1), "device:finalize": (0.02, 1),
}
# the window's device operations (name, start ns, end ns): K3 for 0.07 s
DEV_OPS = [("void kb_scatter_kernel<64>(...)", 0, 40_000_000),
           ("void cross_spectrum_kernel(...)", 40_000_000, 45_000_000),
           ("void kb_scatter_kernel<64>(...)", 50_000_000, 80_000_000)]
READERS = {
    "gallery_dev_s": (0.04 + 0.26) / 2,
    "match_peaks_ms": 0.12 / 4 * 1e3,
    "grid_dev_ms": 0.09 / 2 * 1e3,
    "grid_host_ms": 0.08 / 2 * 1e3,
    "grid_streams_ms": (0.002 + 0.004 + 0.002) / 2 * 1e3,
    "k3_ns_sample": 0.07 / 50_000_000 * 1e9,
    "finish_dev_s": 0.02,
}


def _reader(name):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from cryobench.run import load_module
    return load_module(REPO / "cryobench" / "metrics" / f"{name}.py",
                       f"test_reader_{name.replace('.', '_')}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_benchmark_reader_reads_the_program_spans(name):
    """Each reader on a hand-made traced window; on a CPU run's (no device
    keys, no device operations); and on a program without the spans and
    counters (the parent's), where it returns nothing."""
    reader = _reader(name)
    assert reader.SOURCE == ("device_trace" if name == "k3_ns_sample"
                             else "program_span")
    value = reader.read(SimpleNamespace(phases=dict(PHASES),
                                        dev_ops=list(DEV_OPS)))
    assert value == pytest.approx(READERS[name], rel=1e-12)
    host_only = {k: v for k, v in PHASES.items()
                 if not k.startswith("device:")}
    got = reader.read(SimpleNamespace(phases=host_only, dev_ops=[]))
    if name == "grid_host_ms":
        assert got == pytest.approx(READERS[name], rel=1e-12)
    else:
        assert got is None
    assert reader.read(SimpleNamespace(phases={},
                                       dev_ops=list(DEV_OPS))) is None


def test_benchmark_lists_the_new_readers():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m, reader = entries[name], _reader(name)
        assert (m["source"], m["unit"], m["layer"], m["moves"]) == (
            reader.SOURCE, reader.UNIT, reader.LAYER, reader.MOVES)
