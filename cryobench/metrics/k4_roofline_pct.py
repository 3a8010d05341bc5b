"""K4's share of its roofline: the bound time of the scan's ring
contractions over the device time of the cross-spectrum kernel in the
traced window. The work is counted from the problem's shapes: for every
batch of B images, every trial shift, the gallery's R references, the
scan's rings and 64 harmonics (roofline.cross_work, both spectra)."""
from cryobench import roofline
from cryobench.reference.match import HARMONICS, trial_shifts
from cryobench.trace import kernel_time_s

LAYER = "Kernel K4 (ops/cross.py, csrc/cross.cu)"
UNIT, SOURCE, MOVES = "%", "device_trace", "assign_rate"
KERNEL = "cross_spectrum_kernel"


def read(ctx):
    secs, launches = kernel_time_s(ctx.dev_ops, KERNEL)
    if not launches:
        return None
    T = len(trial_shifts(ctx.mix["max_shift"]))
    R = len(ctx.job.angles)
    nr = roofline.scan_rings(ctx.cfg["sizes"]["box"])
    bound = sum(T * roofline.bound_s(*roofline.cross_work(
        len(res["ref_idx"]), nr, R, HARMONICS)) for _, res in ctx.job.done)
    return 100.0 * bound / secs
