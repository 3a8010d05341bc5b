"""Tracing / profiling subsystem.

SURVEY §5.1: the reference's timing is ad-hoc (#ifdef TIMING blocks around
hot phases, angular_projection_matching.cpp:640). Here it is first-class:
`timed_phase` scopes accumulate wall-clock per phase (printed at exit when
enabled), and `trace` wraps a region in a torch.profiler trace of the host
and the card, exported as a Chrome trace. Every program accepts `--trace <dir>`
(tryRun wraps run()) and phase timing turns on with verbosity >= 2 or
XMIPP_TIMING=1.
"""
from __future__ import annotations

import atexit
import os
import time
from collections import defaultdict
from contextlib import contextmanager

_ACCUM: dict[str, list] = defaultdict(lambda: [0.0, 0])
_ENABLED = None


def timing_enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("XMIPP_TIMING", "0") not in ("0", "")
    return _ENABLED


def enable_timing(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextmanager
def timed_phase(name: str, sync=None):
    """Accumulate wall-clock for a named phase.

    Pass `sync` a tensor that the phase produces so that asynchronous
    launches don't hide device time: timed_phase("x", sync=result)
    synchronizes the tensor's card before the clock stops.
    """
    if not timing_enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None and sync.is_cuda:
            import torch
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - t0
        _ACCUM[name][0] += dt
        _ACCUM[name][1] += 1


def timing_report() -> str:
    if not _ACCUM:
        return ""
    lines = ["-- phase timing --"]
    for name, (tot, n) in sorted(_ACCUM.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"  {name:<32s} {tot:8.3f} s  ({n} calls, "
                     f"{tot / max(n, 1) * 1e3:7.1f} ms/call)")
    return "\n".join(lines)


def take_timing() -> dict[str, tuple[float, int]]:
    """The accumulated {phase: (seconds, calls)}, cleared for the next run."""
    out = {name: (tot, n) for name, (tot, n) in _ACCUM.items()}
    _ACCUM.clear()
    return out


def _report_at_exit():
    if timing_enabled() and _ACCUM:
        print(timing_report())


atexit.register(_report_at_exit)


@contextmanager
def trace(trace_dir: str | None):
    """torch.profiler scope over the host and, when there is one, the card;
    the Chrome trace goes to <trace_dir>/trace.json. No-op when trace_dir
    is falsy."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace -> {path}")
