"""K3's device nanoseconds a sample: the Kaiser-Bessel gridding kernel's
time in the traced window's device trace, over the program's counter
`k3.samples` (the samples handed to the kernel, every symmetry copy)
summed over the same window."""
from cryobench.trace import kernel_time_s

LAYER = "Kernel K3 (ops/scatter_kb.py, csrc/scatter_kb.cu)"
UNIT, SOURCE, MOVES = "ns", "device_trace", "rec_rate"
KERNEL = "kb_scatter_kernel"


def read(ctx):
    samples = ctx.phases.get("count:k3.samples")
    secs, launches = kernel_time_s(ctx.dev_ops, KERNEL)
    if not launches or not samples or not samples[0]:
        return None
    return secs / samples[0] * 1e9
