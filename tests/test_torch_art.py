"""ops/art.py of the port against the reference package's, on the CPU, on
the phantom of tests/test_project_reconstruct.py:199-238 (N=24, P=48, 60
views).

Tolerances, relative to the max of the reference's volume:
- art_reconstruct grids its blocks with the trilinear window (K2's plain
  version against the reference's scatter): 1e-4 after 2-3 iterations in
  every ART_MODES entry and with each option (the measured gap is 1e-7 to
  2e-5; pfSIRT's rescale by max |residual| / max |correction| is the
  largest), residual histories within 1e-5 of their first value;
- SIRT, WBP and SIRT's start grid with the Kaiser-Bessel window: K3's
  degree-7 window polynomial against the reference's exact Bessel window
  (at P=48, whose P^3 is no multiple of 8192, the reference takes its
  exact-window tap path): the kb tolerance of the port's reconstruction
  tests, 5e-3, for the volumes and SIRT's residual histories. SIRT's L1
  and TV regularisers act on the sign and the normalised gradient of the
  volume, which that roundoff decides where the volume is near 0 and
  flat: 1e-2 (read 2.0e-3 and 5.1e-3);
- wbp_direction_set: equal; wbp_arbitrary_filter (the sinc sums in
  float32 in another order): 1e-5; wedge_aware_average: 1e-5.

Each mode is also held to the reference test's own criterion: the
volume's NCC with the phantom > 0.9, positivity, and a residual history
that ends no higher than it starts.
"""
import numpy as np
import pytest
import torch

from xmipp3_tpu.ops import art as jart
from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.sym import SymList
from xmipp3_tpu_torch.ops import art as tart

torch.set_num_threads(1)

N, M = 24, 60
TRI, KB, KB_SIGN = 1e-4, 5e-3, 1e-2


@pytest.fixture(scope="module")
def phantom():
    rng = np.random.default_rng(0)
    z, y, x = np.mgrid[0:N, 0:N, 0:N].astype(np.float64) - N // 2
    vol = np.exp(-((x - 2) ** 2 + y ** 2 + (z + 1) ** 2) / 8)
    rot = rng.uniform(0, 360, M).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, M))).astype(np.float32)
    psi = rng.uniform(0, 360, M).astype(np.float32)
    A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)
    yy, xx = np.mgrid[0:N, 0:N].astype(np.float64) - N // 2
    c = np.array([2.0, 0.0, -1.0])
    u, v = A[:, 0, :] @ c, A[:, 1, :] @ c
    s = np.sqrt(8 / 2.0)
    projs = (s * np.sqrt(2 * np.pi) * np.exp(
        -(((xx[None] - u[:, None, None]) ** 2
           + (yy[None] - v[:, None, None]) ** 2) / 8))).astype(np.float32)
    return dict(vol=vol, projs=projs, rot=rot, tilt=tilt, psi=psi)


def _err(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _ncc(a, b):
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _both(ph, fn, n=M, **kw):
    args = (ph["projs"][:n], ph["rot"][:n], ph["tilt"][:n], ph["psi"][:n])
    want = getattr(jart, fn)(*args, **kw)
    got = getattr(tart, fn)(*args, device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("mode", tart.ART_MODES)
def test_art_modes_match_the_reference(phantom, mode):
    ph = phantom
    kw = dict(mode=mode, n_iters=3, lambda_list=[0.5], positivity=True,
              block_size=15)
    n = M
    if mode == "ART":                 # sequential: one update a view
        n, kw = 10, dict(kw, n_iters=1, lambda_list=[0.2], block_size=None)
    (got, ht), (want, hj) = _both(ph, "art_reconstruct", n, **kw)
    assert got.shape == (N, N, N) and got.dtype == torch.float32
    assert _err(got, want) <= TRI
    assert np.abs(np.array(ht) - hj).max() <= 1e-5 * hj[0]
    vol = got.numpy()
    assert np.isfinite(vol).all() and vol.min() >= 0.0
    if mode != "ART":                 # the reference test's criterion
        assert _ncc(ph["vol"], vol) > 0.9
        assert ht[-1] <= ht[0] + 1e-6


def _options(ph):
    rng = np.random.default_rng(4)
    surf = np.zeros((N, N, N), np.float32)
    surf[:, :3] = 1.0
    return {
        "surface": dict(surface_mask=surf),
        "known_volume": dict(known_volume=2000),
        "sparse": dict(sparse_eps=0.05),
        "diffusion": dict(diffusion_eps=0.05),
        "sphere": dict(sphere_R=9.0),
        "sym_each": dict(sym_mats=SymList("c4").sym_matrices(), sym_each=30),
        "force_sym": dict(sym_mats=SymList("c2").sym_matrices(),
                          force_sym=1),
        "random_sort": dict(random_sort=True, seed=3),
        "sort_last": dict(sort_last=3, no_sort=False),
        "stop_at": dict(stop_at=70),
        "wls": dict(wls=True, kappa_list=[0.3, 0.6]),
        "pixel_masks": dict(pixel_masks=(rng.uniform(size=(M, N, N)) > 0.1)
                            .astype(np.float32)),
        "lambdas_pocs_freq": dict(lambda_list=[0.8, 0.4], pocs_freq=2),
        "init_vol": dict(init_vol=0.5 * ph["vol"].astype(np.float32)),
        "shifts": dict(sx=rng.uniform(-1, 1, M).astype(np.float32),
                       sy=rng.uniform(-1, 1, M).astype(np.float32)),
        "refine": dict(refine=True, ref_trans_step=1.0),
    }


OPTIONS = ["surface", "known_volume", "sparse", "diffusion", "sphere",
           "sym_each", "force_sym", "random_sort", "sort_last", "stop_at",
           "wls", "pixel_masks", "lambdas_pocs_freq", "init_vol", "shifts",
           "refine"]


@pytest.mark.parametrize("option", OPTIONS)
def test_art_options_match_the_reference(phantom, option):
    kw = dict(mode="pSART", n_iters=2, lambda_list=[0.5], positivity=True,
              block_size=20)
    kw.update(_options(phantom)[option])
    (got, ht), (want, hj) = _both(phantom, "art_reconstruct", **kw)
    assert _err(got, want) <= TRI
    assert len(ht) == len(hj)
    assert np.abs(np.array(ht) - hj).max() <= 1e-5 * hj[0]


def test_art_ctf_matches_the_reference(phantom):
    """--ctf: the theoretical projections go through the CTF (the port's
    CTFDescription against the reference's, the same parameters)."""
    from xmipp3_tpu.ops.ctf import CTFDescription as JCTF
    from xmipp3_tpu_torch.ops.ctf import CTFDescription as TCTF
    p = dict(sampling_rate=2.0, voltage=300.0, defocusU=8000.0,
             defocusV=8200.0, Cs=2.7, Q0=0.1)
    args = (phantom["projs"], phantom["rot"], phantom["tilt"],
            phantom["psi"])
    kw = dict(mode="pSART", n_iters=2, block_size=20)
    want, hj = jart.art_reconstruct(*args, ctf=JCTF(**p), **kw)
    got, ht = tart.art_reconstruct(*args, ctf=TCTF(**p), device="cpu", **kw)
    assert _err(got, want) <= TRI
    assert np.abs(np.array(ht) - hj).max() <= 1e-5 * hj[0]


def test_art_unknown_mode_raises(phantom):
    with pytest.raises(ValueError, match="unknown ART mode"):
        tart.art_reconstruct(phantom["projs"], phantom["rot"],
                             phantom["tilt"], phantom["psi"], mode="MART",
                             device="cpu")


SIRT = {"plain": ({}, KB), "ridge": (dict(ridge=0.01), KB),
        "tv": (dict(tv=0.01), KB_SIGN), "l1": (dict(l1=1e-3), KB_SIGN),
        "soft_threshold": (dict(soft_threshold=1e-3), KB),
        "mask_positivity": (dict(positivity=True), KB)}


@pytest.mark.parametrize("case", list(SIRT))
def test_sirt_regularisers_match_the_reference(phantom, case):
    kw, tol = SIRT[case]
    if case == "mask_positivity":
        kw = dict(kw, vol_mask=(phantom["vol"] > 0.1).astype(np.float32))
    seen = []
    (got, ht), (want, hj) = _both(
        phantom, "sirt_reconstruct", n_iters=3, **kw)
    tart.sirt_reconstruct(phantom["projs"], phantom["rot"], phantom["tilt"],
                          phantom["psi"], n_iters=1, device="cpu",
                          iter_callback=lambda it, v: seen.append(it), **kw)
    assert seen == [1]
    assert _err(got, want) <= tol
    assert np.abs(np.array(ht) - hj).max() <= KB * hj[0]
    assert _ncc(phantom["vol"], got.numpy()) > 0.9


@pytest.mark.parametrize("kw", [
    {}, dict(use_each_image=True, sym="c4"),
    dict(filsam=10, weights=np.linspace(0.5, 2.5, M)),
    dict(filsam=7, sym="d2")], ids=["sampled", "each_c4", "weights", "d2"])
def test_wbp_direction_set_equals_the_reference(phantom, kw):
    a = (phantom["rot"], phantom["tilt"], phantom["psi"])
    g, c = tart.wbp_direction_set(*a, **kw)
    gj, cj = jart.wbp_direction_set(*a, **kw)
    np.testing.assert_array_equal(g, gj)
    np.testing.assert_array_equal(c, cj)


@pytest.mark.parametrize("diameter,threshold", [(None, 0.005), (20, 0.05)])
def test_wbp_arbitrary_filter_matches_the_reference(phantom, diameter,
                                                    threshold, monkeypatch):
    """In chunks of 7 images (the chunk's byte cap lowered), against the
    reference's image-by-image map."""
    ph = phantom
    g, c = jart.wbp_direction_set(ph["rot"], ph["tilt"], ph["psi"])
    a = (ph["projs"], ph["rot"], ph["tilt"], ph["psi"], g, c)
    want = np.asarray(jart.wbp_arbitrary_filter(*a, diameter=diameter,
                                                threshold=threshold))
    monkeypatch.setattr(tart, "WBP_CHUNK_BYTES", 7 * 4 * N * N * len(c))
    got = tart.wbp_arbitrary_filter(*a, diameter=diameter,
                                    threshold=threshold, device="cpu")
    assert got.shape == (M, N, N)
    assert _err(got, want) <= 1e-5


@pytest.mark.parametrize("kw", [
    {}, dict(filter_diameter=18), dict(mode="arbitrary"),
    dict(mode="arbitrary", weights=np.linspace(0.5, 1.5, M), sym="c2",
         filsam=10, threshold=0.01),
    dict(mode="arbitrary", use_each_image=True, filter_diameter=20)],
    ids=["ramp", "ramp_diameter", "arbitrary", "arbitrary_weights",
         "arbitrary_each"])
def test_wbp_reconstruct_matches_the_reference(phantom, kw):
    got, want = _both(phantom, "wbp_reconstruct", **kw)
    assert _err(got, want) <= KB


@pytest.mark.parametrize("align", [True, False])
def test_wedge_aware_average_matches_the_reference(align):
    rng = np.random.default_rng(8)
    subs = rng.standard_normal((3, 16, 16, 16)).astype(np.float32)
    ang = [rng.uniform(0, 90, 3).astype(np.float32) for _ in range(3)]
    want = jart.wedge_aware_average(subs, *ang, t1=-50, t2=55,
                                    apply_alignment=align)
    got = tart.wedge_aware_average(subs, *ang, t1=-50, t2=55,
                                   apply_alignment=align, device="cpu")
    assert got.dtype == torch.float32
    assert _err(got, want) <= 1e-5


def test_parallel_art_correction_on_one_rank_is_the_serial_block(phantom):
    """On a mesh of one rank (no process group), the block correction, its
    residual sum and max |residual| equal the serial block's."""
    from xmipp3_tpu_torch.parallel.mesh import data_mesh
    from xmipp3_tpu_torch.parallel.reconstruct import parallel_art_correction
    ph = phantom
    vol = torch.as_tensor(0.7 * ph["vol"], dtype=torch.float32)
    sel = slice(5, 22)
    corr, ss, rmax = parallel_art_correction(
        data_mesh(device="cpu"), vol, ph["projs"][sel], ph["rot"][sel],
        ph["tilt"][sel], ph["psi"][sel])
    mats = np.asarray(euler_matrix(ph["rot"][sel], ph["tilt"][sel],
                                   ph["psi"][sel]), np.float32)
    resid = torch.as_tensor(ph["projs"][sel]) - tart._forward(vol, mats, N)
    want = tart._backproject(resid, ph["rot"][sel], ph["tilt"][sel],
                             ph["psi"][sel], 2.0, interp="tri")
    assert _err(corr, want) <= 1e-6
    assert abs(ss - float((resid ** 2).sum())) <= 1e-5 * ss
    assert rmax == float(resid.abs().max())
