"""K3's share of its roofline: the bound time of the window's gridding
over the device time of the Kaiser-Bessel kernel in the traced window.
The work of a batch is counted from its samples (every symmetry copy of
every kept frequency of its particles), their live 4x4x4 taps and the
voxels they touch (roofline.kb_tap_stats, kb_work); it is counted exactly
on four batches spread over the window and their mean stands for each
batch."""
import numpy as np

from cryobench import roofline
from cryobench.data import euler_matrix
from cryobench.symmetry import group
from cryobench.trace import kernel_time_s

LAYER = "Kernel K3 (ops/scatter_kb.py, csrc/scatter_kb.cu)"
UNIT, SOURCE, MOVES = "%", "device_trace", "rec_rate"
KERNEL = "kb_scatter_kernel"
SAMPLED = 4


def read(ctx):
    secs, launches = kernel_time_s(ctx.dev_ops, KERNEL)
    batches = ctx.job.batches
    if not launches or not batches:
        return None
    sz, mix = ctx.cfg["sizes"], ctx.mix
    n = sz["box"]
    P = int(round(n * mix["pad"]))
    P += P % 2
    p = ctx.data.poses
    sym = group(sz["sym"])
    pick = np.unique(np.linspace(0, len(batches) - 1, SAMPLED).astype(int))
    bounds = []
    for i in pick:
        s = batches[i]
        e = min(s + mix["batch"], ctx.data.stack.shape[0])
        A = euler_matrix(p["rot"][s:e], p["tilt"][s:e], p["psi"][s:e])
        coords = [roofline.slice_coords(np.einsum("cij,jk->cik", A, S), n,
                                        P, mix["max_freq"], ctx.dev)
                  for S in sym]
        stats = roofline.kb_tap_stats(coords, P, float(mix["blob"][0]))
        bounds.append(roofline.bound_s(*roofline.kb_work(*stats)))
    return 100.0 * float(np.mean(bounds)) * len(batches) / secs
