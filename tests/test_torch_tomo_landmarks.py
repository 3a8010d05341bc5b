"""ops/tomo_landmarks.py and the k-means of programs/scripts_misc.py against
the reference package's, on the CPU.

Tolerances:
- directional_enhance: 1e-5 of the max (float32 roundoff of two rfft2
  passes and a product; read 3e-7), on square and non-square frames, at
  every cone count the programs use;
- downsample_factor: equal (host arithmetic);
- _kmeans: the same labels from the same default_rng draws, on separated
  clusters and on overlapping ones (float64 distances in both; the port's
  on the device).
"""
import numpy as np
import pytest
import torch

from xmipp3_tpu.ops import tomo_landmarks as jtl
from xmipp3_tpu.programs.scripts_misc import _kmeans as jkmeans
from xmipp3_tpu_torch.ops import tomo_landmarks as tl
from xmipp3_tpu_torch.programs.scripts_misc import _kmeans

torch.set_num_threads(1)


def _frames(shape, seed):
    """Dark disks of 4 px radius on noise: fiducial-like frames."""
    rng = np.random.default_rng(seed)
    F, H, W = shape
    imgs = rng.standard_normal(shape).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(F):
        for _ in range(5):
            cy, cx = rng.uniform(6, H - 6), rng.uniform(6, W - 6)
            imgs[f][(yy - cy) ** 2 + (xx - cx) ** 2 < 16] -= 4.0
    return imgs


@pytest.mark.parametrize("shape,target,n_dirs", [
    ((5, 48, 48), 8.0, 8), ((3, 40, 56), 6.0, 4), ((4, 32, 32), 10.0, 12)])
def test_directional_enhance_matches_the_reference(shape, target, n_dirs):
    imgs = _frames(shape, 3)
    want = np.asarray(jtl.directional_enhance(imgs, target, n_dirs))
    got = tl.directional_enhance(imgs, target, n_dirs, device="cpu").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_directional_enhance_stays_on_the_tensors_device():
    x = torch.as_tensor(_frames((2, 32, 32), 4))
    assert tl.directional_enhance(x, 8.0).device == x.device


@pytest.mark.parametrize("fid,target", [(20.0, 8.0), (4.0, 8.0), (33.3, 0.5)])
def test_downsample_factor_matches_the_reference(fid, target):
    assert tl.downsample_factor(fid, target) == \
        jtl.downsample_factor(fid, target)


@pytest.mark.parametrize("spread,k", [(0.3, 3), (1.5, 4), (3.0, 2)])
def test_kmeans_labels_match_the_reference(spread, k):
    rng = np.random.default_rng(11)
    centres = rng.normal(0, 3, (k, 6))
    X = np.concatenate([c + spread * rng.standard_normal((25, 6))
                        for c in centres])
    want = jkmeans(X, k, np.random.default_rng(0))
    got = _kmeans(X, k, np.random.default_rng(0), device="cpu")
    np.testing.assert_array_equal(got, want)
    # the Generator is left where the reference leaves it
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    jkmeans(X, k, a, iters=5, restarts=3)
    _kmeans(torch.as_tensor(X), k, b, iters=5, restarts=3, device="cpu")
    assert a.random() == b.random()
