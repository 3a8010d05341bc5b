"""ops/match.py of the port against the reference package on the CPU: a
noisy 15-degree gallery at N=32, and the port's copies of the four tests
of tests/test_match.py (N=48).

The coarse scan picks winners by argmax, so the two packages may part ways
where two candidates tie within roundoff (with a full-sphere gallery the
antipodal view mirrored is an exact tie, and counts as the same answer).
Held to: the same ref_idx and flip for >= 98 % of the images and, on those, psi <= 0.5 deg, shifts <= 0.05 px,
corr <= 1e-3; the score matrix's peaks <= 1e-4 on every pair."""
import numpy as np
import pytest
import torch

from test_torch_project import phantom8
from xmipp3_tpu.ops import match as jmatch
from xmipp3_tpu_torch.core.sampling import Sampling, directions_from_angles
from xmipp3_tpu_torch.ops import cross, match
from xmipp3_tpu_torch.ops.geo import apply_alignment_2d, apply_md_geometry
from xmipp3_tpu_torch.ops.project import FourierProjector

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _gallery(n):
    vol = phantom8(n, scale=1.0 if n == 48 else None)
    angles = Sampling(15.0, "c1").angles
    refs = FourierProjector(vol, **CPU).project_euler(
        angles[:, 0], angles[:, 1], np.zeros(len(angles))).numpy()
    return angles, refs


@pytest.fixture(scope="module")
def noisy():
    """A 15-degree gallery at N=32 and 40 noisy members of it, rotated and
    shifted by up to 3 px."""
    angles, refs = _gallery(32)
    rng = np.random.default_rng(0)
    B = 40
    idx = rng.integers(0, len(refs), B)
    imgs = apply_alignment_2d(
        refs[idx], rng.uniform(-180, 180, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32), **CPU).numpy()
    imgs += 0.1 * refs.std() * rng.standard_normal(imgs.shape).astype(
        np.float32)
    return angles, refs, imgs


def _np(d):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in d.items()}


def _hold(got, want, B, angles):
    """The agreement this file's docstring states, over flattened outputs.
    A pair of answers that names antipodal directions with opposite flips
    is the exact tie: it counts as agreement in direction, score and
    correlation, while its psi and shifts belong to different poses."""
    got = {k: v.reshape(B, -1) for k, v in got.items()}
    want = {k: v.reshape(B, -1) for k, v in want.items()}
    same = (got["ref_idx"] == want["ref_idx"]) & (got["flip"] == want["flip"])
    d = directions_from_angles(angles)
    cosd = (d[got["ref_idx"]] * d[want["ref_idx"]]).sum(-1)
    tie = ~same & (got["flip"] != want["flip"]) & (cosd < -0.9999)
    assert (same | tie).mean() >= 0.98
    assert same.mean() >= 0.8
    for k, tol in (("corr", 1e-3), ("peak", 1e-4)):
        assert np.abs(got[k] - want[k])[tie].max(initial=0) <= tol
    dpsi = np.abs((got["psi"] - want["psi"] + 180) % 360 - 180)
    assert dpsi[same].max() <= 0.5
    for k in ("sx", "sy"):
        assert np.abs(got[k] - want[k])[same].max() <= 0.05
    assert np.abs(got["corr"] - want["corr"])[same].max() <= 1e-3
    assert np.abs(got["peak"] - want["peak"])[same].max() <= 1e-4


@pytest.mark.parametrize("case", ["top1", "top3", "allowed", "psi_allow",
                                  "no_mirror", "trial_step"])
def test_match_to_gallery_matches_the_reference(noisy, case):
    angles, refs, imgs = noisy
    B, R = len(imgs), len(refs)
    rng = np.random.default_rng(1)
    kw = dict(max_shift=4)
    if case == "top3":
        kw["n_orientations"] = 3
    elif case == "allowed":
        kw["allowed"] = (rng.uniform(size=(B, R)) < 0.5).astype(np.float32)
    elif case == "psi_allow":
        keep = (np.arange(match.N_ANGLES) % 2 == 0).astype(np.float32)
        kw["psi_allow"] = np.broadcast_to(keep, (B, match.N_ANGLES)).copy()
    elif case == "no_mirror":
        kw["check_mirror"] = False
    elif case == "trial_step":
        kw.update(max_shift=3, trial_step=1.0, refine_iters=1)
    want = _np(jmatch.match_to_gallery(refs, imgs, **kw))
    before = cross.launches
    got = _np(match.match_to_gallery(refs, imgs, **kw, **CPU))
    assert cross.launches == before       # CPU tensors: K4's plain version
    want.pop("aligned", None)
    got.pop("aligned", None)
    assert set(got) == set(want)
    shape = (B, 3) if case == "top3" else (B,)
    assert all(v.shape == shape for v in got.values())
    _hold(got, want, B, angles)
    if case == "allowed":
        assert (kw["allowed"][np.arange(B), got["ref_idx"]] > 0).all()
    if case == "no_mirror":
        assert not got["flip"].any()


def test_match_score_matrix_matches_the_reference(noisy):
    angles, refs, imgs = noisy
    want = _np(jmatch.match_score_matrix(refs, imgs[:12], max_shift=4))
    got = _np(match.match_score_matrix(refs, imgs[:12], max_shift=4, **CPU))
    np.testing.assert_array_equal(got["trials"], want["trials"])
    assert got["peak"].shape == (12, len(refs))
    assert np.abs(got["peak"] - want["peak"]).max() <= 1e-4
    same = (got["trial"] == want["trial"]) & (got["flip"] == want["flip"])
    assert same.mean() >= 0.98
    dpsi = np.abs((got["psi"] - want["psi"] + 180) % 360 - 180)
    assert np.quantile(dpsi[same], 0.98) <= 0.5


def test_trial_shift_grid_is_the_reference():
    for ms, step in ((0, None), (4, None), (4, 1.0), (16, None), (3, 2.0)):
        np.testing.assert_array_equal(match._trial_shift_grid(ms, step),
                                      jmatch._trial_shift_grid(ms, step))
    assert len(match._trial_shift_grid(4)) == 13
    assert match.N_ANGLES == jmatch.N_ANGLES == 254


# -- the port's copies of tests/test_match.py -------------------------------

@pytest.fixture(scope="module")
def gallery():
    return _gallery(48)


def test_match_identity(gallery):
    angles, refs = gallery
    # mirror check off: with a full-sphere gallery the antipodal view
    # mirrored is an exact tie
    idx = [0, 5, 17, len(refs) - 2]
    res = _np(match.match_to_gallery(refs, refs[idx], max_shift=4,
                                     check_mirror=False, **CPU))
    assert list(res["ref_idx"]) == idx
    assert np.allclose(res["psi"], 0, atol=2.0)
    assert (res["corr"] > 0.98).all()


def test_match_with_pose(gallery):
    angles, refs = gallery
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(refs), 6)
    psis = rng.uniform(-180, 180, 6).astype(np.float32)
    sxs = rng.uniform(-4, 4, 6).astype(np.float32)
    sys_ = rng.uniform(-4, 4, 6).astype(np.float32)
    imgs = apply_alignment_2d(refs[idx], psis, sxs, sys_, **CPU)
    res = _np(match.match_to_gallery(refs, imgs, max_shift=6, **CPU))
    assert (res["corr"] > 0.93).all(), res["corr"]
    # recovered reference must be the true direction — or, for mirrored
    # matches, its antipode (proj(-d) == mirror(proj(d)))
    d = directions_from_angles(angles)
    for i in range(6):
        got = d[res["ref_idx"][i]]
        target = -got if res["flip"][i] else got
        ang_err = np.degrees(np.arccos(np.clip(np.dot(d[idx[i]], target),
                                               -1, 1)))
        assert ang_err < 16.0, f"img {i}: {ang_err}"


def test_match_metadata_convention(gallery):
    """(psi, sx, sy, flip) written by matching must register the raw image
    onto the matched reference through apply_md_geometry — the framework-wide
    metadata pose contract every consumer relies on."""
    angles, refs = gallery
    imgs = np.stack([refs[3], refs[10][::-1, :]])  # one straight, one y-flip
    res = match.match_to_gallery(refs, imgs, max_shift=4, **CPU)
    registered = apply_md_geometry(torch.as_tensor(imgs), res["psi"],
                                   res["sx"], res["sy"], res["flip"]).numpy()
    for i in range(2):
        ref_img = refs[int(res["ref_idx"][i])]
        c = np.corrcoef(registered[i].ravel(), ref_img.ravel())[0, 1]
        assert c > 0.97, f"img {i}: {c}"


def test_match_detects_mirror(gallery):
    """On a HALF-sphere gallery mirror detection is meaningful (full-sphere
    galleries make mirrors exact antipodal ties)."""
    angles, refs = gallery
    half = angles[:, 1] <= 90.0
    h_refs = refs[half]
    h_angles = angles[half]
    # pick a ref well inside the half sphere
    k = int(np.argmax(np.where(h_angles[:, 1] < 60, h_angles[:, 1], -1)))
    imgs = np.stack([h_refs[k], h_refs[k][::-1, :]])
    res = _np(match.match_to_gallery(h_refs, imgs, max_shift=4, **CPU))
    assert (res["corr"] > 0.95).all()
    assert not res["flip"][0]
    if int(res["ref_idx"][1]) == k:
        assert res["flip"][1]
