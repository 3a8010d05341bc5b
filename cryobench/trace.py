"""Reading the traced window: device operations from `torch.profiler`'s
CUDA activity, the host spans the benchmark marks with `record_function`,
and from them the device's busy time, its idle gaps and the operations that
took most time."""
from __future__ import annotations

from collections import defaultdict

SPAN_PREFIX = "cryobench/"


def collect(prof):
    """(device ops, host events, t0, t1) of a profile, clipped to the
    benchmark's span "window" [t0, t1] on the profiler's clock (ns): lists
    of (name, start, end); host events are the benchmark's spans and the
    operators the host ran."""
    import torch
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == SPAN_PREFIX + "window"
           and e.device_type() == torch.autograd.DeviceType.CPU]
    t0_ns = win[0].start_ns()
    t1_ns = t0_ns + win[0].duration_ns()
    dev, host = [], []
    for e in events:
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and (e.is_user_annotation()
                          or e.name().startswith(SPAN_PREFIX)):
            continue      # a span's copy on the device's timeline
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= t0_ns or s >= t1_ns:
            continue
        item = (e.name(), max(s, t0_ns), min(t, t1_ns))
        if on_device:
            dev.append(item)
        else:
            host.append(item)
    return dev, host, t0_ns, t1_ns


def merged(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_ns(dev_ops) -> int:
    return sum(t - s for s, t in merged((s, t) for _, s, t in dev_ops))


def top_ops(dev_ops, count: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    tot = defaultdict(int)
    for name, s, t in dev_ops:
        tot[name] += t - s
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:count]
    return [[name[:160], ns * 1e-9] for name, ns in best]


def idle_gaps(dev_ops, host, t0_ns: int, t1_ns: int, count: int = 10):
    """[[what the host was doing, seconds]] of the longest stretches in
    which no operation ran on the device, named by the benchmark span and
    the innermost host operation that covered the stretch's start."""
    busy = merged((s, t) for _, s, t in dev_ops)
    gaps, last = [], t0_ns
    for s, t in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if t1_ns > last:
        gaps.append((last, t1_ns))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
    out = []
    for s, t in gaps:
        cover = [(e - b, n) for n, b, e in host if b <= s < e]
        spans = [c for c in cover if c[1].startswith(SPAN_PREFIX)]
        ops = [c for c in cover if not c[1].startswith(SPAN_PREFIX)]
        what = [max(spans)[1][len(SPAN_PREFIX):] if spans else "window",
                min(ops)[1] if ops else "python"]
        out.append([" / ".join(what)[:160], (t - s) * 1e-9])
    return out


def kernel_time_s(dev_ops, marker: str):
    """(seconds, launches) of the device operations whose name holds
    `marker`."""
    hits = [(t - s) for name, s, t in dev_ops if marker in name]
    return sum(hits) * 1e-9, len(hits)
