"""Tracing / profiling subsystem.

SURVEY §5.1: the reference's timing is ad-hoc (#ifdef TIMING blocks around
hot phases, angular_projection_matching.cpp:640). Here it is first-class:
`timed_phase` scopes are the program's spans, `count` its work counters, and
`trace` wraps a region in a torch.profiler trace of the host and the card,
exported as a Chrome trace. Every program accepts `--trace <dir>` (tryRun
wraps run()); timing is on with verbosity >= 2, inside `trace`, or after
`enable_timing()`. With timing off a span or a counter costs one test of a
module flag: no event, no profiler range, no stack. Inside `trace` alone
the spans are on but `sync=` does not synchronise, so that the trace shows
the run as an untimed run queues it.

With timing on, a span `timed_phase(name)`:
- opens `torch.profiler.record_function("xmipp/" + name)`, so that it lies
  on the profiler's clock beside the card's kernels;
- records its parent, the innermost span open on its thread when it starts:
  a span's self time is its host time less the host time of its children;
- once CUDA is initialised, and unless the current stream is being captured
  into a CUDA graph, records a pair of timing events at its start and end,
  both on the stream current at its start. They are resolved only when the
  timing is read (`take_timing`, `timing_report`: `Event.synchronize` on the
  end events still pending, never a device synchronise); a long run folds
  pairs the card has completed into the sums once many are pending.
  A span's device time is the time from when the stream reaches the span's
  first operation to when it finishes its last one, idle stretches inside
  the span included;
- with `sync=` a tensor and timing on by `enable_timing` (`-v 2`),
  synchronises that tensor's card before its host clock stops, so that its
  host time holds the device time.
The profiler range holds the span's own bookkeeping: a gap the span's
bookkeeping leaves on the card is named by the span, not by its parent.

`take_timing()` returns and clears {key: (total, calls)}:
  "<span>"            host seconds and calls of a span;
  "device:<span>"     device seconds and calls of a span that ran while CUDA
                      was initialised;
  "count:<counter>"   a counter's total and its number of increments.
"""
from __future__ import annotations

import atexit
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

SPAN_PREFIX = "xmipp/"
DEVICE, COUNT = "device:", "count:"
# pending event pairs that start a fold. Resolving a pair takes four runtime
# calls (a query, and the two inside elapsed_time), so pairs wait to be
# resolved when the timing is read: a traced window of tens of thousands of
# spans resolves none of them inside it, and a long run holds at most this
# many pairs of small CUDA events
_FOLD_AT = 1 << 15

_ENABLED = False        # spans and counters record
_SYNC = False           # `sync=` synchronises (enable_timing, not trace)
_ACCUM: dict[str, list] = defaultdict(lambda: [0.0, 0])
_CHILDREN: dict[str, float] = defaultdict(float)   # children's host seconds
_TOP = [0.0]            # host seconds of the spans opened at top level
_PENDING: deque = deque()                           # (span, start, end)
_LOCAL = threading.local()


def timing_enabled() -> bool:
    return _ENABLED


def enable_timing(on: bool = True) -> None:
    global _ENABLED, _SYNC
    _ENABLED = _SYNC = on


def count(name: str, n) -> None:
    """Add n to the counter `name` (reported as "count:<name>")."""
    if not _ENABLED:
        return
    acc = _ACCUM[COUNT + name]
    acc[0] += n
    acc[1] += 1


def _fold(block: bool) -> None:
    """Fold the pending event pairs into the device sums, in order; without
    `block`, up to the first pair the card has not completed."""
    while _PENDING:
        name, start, end = _PENDING[0]
        if block:
            end.synchronize()
        elif not end.query():
            return
        _PENDING.popleft()
        acc = _ACCUM[DEVICE + name]
        acc[0] += start.elapsed_time(end) * 1e-3
        acc[1] += 1


@contextmanager
def timed_phase(name: str, sync=None):
    """A span of the program named `name` (see the module docstring).

    Pass `sync` a tensor that the phase produces so that its host time
    holds its device time: with timing on by `enable_timing`,
    timed_phase("x", sync=result) synchronises the tensor's card before the
    clock stops."""
    if not _ENABLED:
        yield
        return
    import torch
    scope = torch.profiler.record_function(SPAN_PREFIX + name)
    scope.__enter__()
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    children = [0.0]            # host seconds of this span's children
    stack.append(children)
    events = None
    if torch.cuda.is_initialized() and \
            not torch.cuda.is_current_stream_capturing():
        stream = torch.cuda.current_stream()
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record(stream)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if events is not None:
            events[1].record(stream)
        if _SYNC and sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - t0
        stack.pop()
        acc = _ACCUM[name]
        acc[0] += dt
        acc[1] += 1
        _CHILDREN[name] += children[0]
        if stack:
            stack[-1][0] += dt
        else:
            _TOP[0] += dt
        if events is not None:
            _PENDING.append((name, *events))
            if len(_PENDING) >= _FOLD_AT:
                _fold(block=False)
        scope.__exit__(None, None, None)


def top_level_s() -> float:
    """Host seconds of the spans opened with no span around them since the
    last `take_timing()`: what a caller's wall clock holds of the spans,
    each second once."""
    return _TOP[0]


def timing_report() -> str:
    _fold(block=True)
    spans = {k: v for k, v in _ACCUM.items()
             if not k.startswith((DEVICE, COUNT))}
    counters = {k[len(COUNT):]: v for k, v in _ACCUM.items()
                if k.startswith(COUNT)}
    lines = []
    if spans:
        lines += ["-- phase timing --",
                  f"  {'span':<32s} {'host s':>9s} {'self s':>9s} "
                  f"{'device s':>9s} {'calls':>7s} {'ms/call':>9s}"]
    for name, (tot, n) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        dev = _ACCUM.get(DEVICE + name)
        dev_s = f"{dev[0]:9.3f}" if dev else f"{'-':>9s}"
        lines.append(f"  {name:<32s} {tot:9.3f} "
                     f"{tot - _CHILDREN.get(name, 0.0):9.3f} {dev_s} "
                     f"{n:7d} {tot / max(n, 1) * 1e3:9.1f}")
    if counters:
        lines.append("-- counters --")
    for name, (tot, n) in sorted(counters.items()):
        lines.append(f"  {name:<32s} {tot:>14g}  ({n} increments)")
    return "\n".join(lines)


def take_timing() -> dict[str, tuple[float, int]]:
    """The accumulated {key: (total, calls)} (keys as in the module
    docstring), cleared for the next run."""
    _fold(block=True)
    out = {name: (tot, n) for name, (tot, n) in _ACCUM.items()}
    _ACCUM.clear()
    _CHILDREN.clear()
    _TOP[0] = 0.0
    return out


def _report_at_exit():
    if _ENABLED and _ACCUM:
        print(timing_report())


atexit.register(_report_at_exit)


@contextmanager
def trace(trace_dir: str | None):
    """torch.profiler scope over the host and, when there is one, the card,
    with the program's spans on for its scope (their `sync=` synchronises
    only if timing was on already); the Chrome trace goes to
    <trace_dir>/trace.json. No-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    global _ENABLED
    was = _ENABLED
    _ENABLED = True
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        _ENABLED = was
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace -> {path}")
