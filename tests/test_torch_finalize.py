"""The port's finalize_volume against the reference's, for every gridding
window, weight-correction depth and deapodization, on the same accumulators
(those of one gridded batch at N=32, P=64)."""
import numpy as np
import pytest
import torch

from test_torch_common import particle_batch, rel_err
from xmipp3_tpu.core.geometry import euler_matrix
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu_torch.ops import reconstruct as trec

torch.set_num_threads(1)

N, P, C = 32, 64, 8
TOL = {"tri": 1e-4, "tri+kb": 1e-4, "nn": 1e-4, "kb": 5e-3}
_ACC = {}


def accumulators(interp):
    """Gridded accumulators of one batch (the port's, as numpy)."""
    if interp not in _ACC:
        b = particle_batch(5, C, N)
        mats = np.asarray(euler_matrix(b["rot"], b["tilt"], b["psi"]),
                          np.float32)
        cubes = [torch.zeros((P, P, P)) for _ in range(3)]
        trec.backproject_chunk(*cubes, b["imgs"], mats, b["sx"], b["sy"],
                               b["w"], P, interp=interp)
        _ACC[interp] = [c.numpy() for c in cubes]
    return _ACC[interp]


@pytest.mark.parametrize("deapodize", [False, True])
@pytest.mark.parametrize("niter", [1, 2])
@pytest.mark.parametrize("interp", ["tri", "tri+kb", "kb", "nn"])
def test_finalize_volume_matches_reference(interp, niter, deapodize):
    acc = accumulators(interp)
    want = np.asarray(jrec.finalize_volume(
        *acc, N, P, interp=interp, niter_weight=niter, deapodize=deapodize))
    got = trec.finalize_volume(*(torch.tensor(a) for a in acc), N, P,
                               interp=interp, niter_weight=niter,
                               deapodize=deapodize)
    assert got.shape == (N, N, N) and got.dtype == torch.float32
    assert rel_err(got, want) <= TOL[interp]


def test_finalize_without_weight_correction_matches_reference():
    acc = accumulators("tri")
    want = np.asarray(jrec.finalize_volume(*acc, N, P, niter_weight=0))
    got = trec.finalize_volume(*(torch.tensor(a) for a in acc), N, P,
                               niter_weight=0)
    assert rel_err(got, want) <= 1e-4


def test_blob_grid_kernel_and_deapodization_match_reference():
    for blob in [(1.9, 0, 15.0), (2.5, 0, 10.0), (2.0, 2, 10.4)]:
        np.testing.assert_allclose(trec._blob_grid_kernel(blob),
                                   jrec._blob_grid_kernel(blob), rtol=1e-6)
    for interp in ("tri", "tri+kb", "kb", "nn"):
        np.testing.assert_allclose(trec._deapodization(N, P, interp),
                                   jrec._deapodization(N, P, interp),
                                   rtol=1e-6)
