"""ML2D/MLF2D of the port (xmipp3_tpu_torch.models.ml2d) against the
reference package's on the CPU, on the same numpy-seeded images at N=32.

- _energy_terms (whose cross term goes through ops/cross.cross_spectrum,
  K4's plain version on the CPU): cross, e_img and e_ref <= 1e-4 of their
  max.
- _e_step, Gaussian and student-t, with -C and a psi mask: the top-K
  weights <= 1e-4, the indices of every weight above 1e-3 equal, the class
  masses, offset moment and log-likelihood <= 1e-4 relative. The residual
  moment is held to a float64 numpy evaluation of the same posterior at
  1e-6 and to the reference's at 1e-3: the reference's float32 einsum over
  B*T*R*A cells (ml2d.py:140) was read 2.0e-4 off the float64 value where
  the port's sum is 2e-8 off (N=32, 40 images, seed 0 of test_classify's
  two-class set).
- _m_step on the reference's top-K: accumulators <= 1e-4 * max, poses
  <= 1e-4; _ring_noise_spectra and _fit_gray <= 1e-4.
- ml2d's log-likelihood history over 4 iterations <= 1e-4 relative, the
  same classes, references <= 1e-3 * max (tests/test_classify.py's
  4-prototype set); with --mirror, --student, --psi_step, -C, the MLF2D
  noise model, --norm and --kstest the history <= 5e-4 (the residual
  moment above, compounded over the iterations).
- The option properties of tests/test_ml2d_options.py on the port.
- --iem: the port updates the model after every block (ROADMAP.md §3
  item 9); its log-likelihood rises, and one block is the plain EM.
- The mesh path (ml_align2d --mesh dp over 2 gloo ranks of the CLI)
  against the port's serial run: references <= 1e-3 * max, fractions
  <= 1e-4, the same classes; only rank 0 writes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_classify import two_class_stack
from test_ml2d_options import _mirror_dataset
from test_torch_cl2d import four_class_set
from test_torch_common import Ranks, rel_err
from xmipp3_tpu.models import ml2d as jml
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.models import ml2d as tml
from xmipp3_tpu_torch.ops.geo import centered_flip
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)

RMIN, RMAX = 2, 14            # N=32


@pytest.fixture(scope="module")
def terms():
    """Both packages' energy terms of test_classify's two-class set against
    its initial references (2 classes and their mirrors), 13 trials."""
    imgs = two_class_stack(noise=0.3, size=32)[0]
    refs = imgs[:2] * 0.5 + imgs[2:4] * 0.5
    refs = np.concatenate([refs, np.asarray(centered_flip(
        torch.as_tensor(refs), -1))])
    trials = jml._trial_shift_grid(4, step=2.0)
    rw = np.linspace(0.5, 1.5, RMAX - RMIN + 1).astype(np.float32)
    want = [np.asarray(a) for a in jml._energy_terms(refs, imgs, trials, rw,
                                                     RMIN, RMAX)]
    got = tml._energy_terms(refs, imgs, trials, rw, RMIN, RMAX,
                            device="cpu")
    return imgs, trials, want, got


def test_energy_terms_match_the_reference(terms):
    _, _, want, got = terms
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert rel_err(g, w) <= 1e-4


def _f64_resid2_sum(cross, e_img, e_ref, trials, la, s2, so2, mask, c_sig):
    r2 = np.maximum(e_img[:, :, None, None].astype(np.float64)
                    + e_ref[None, None, :, None] - 2 * cross, 0)
    t2 = (trials.astype(np.float64) ** 2).sum(1)
    loge = (-r2 / (2 * s2) - (t2 / (2 * so2))[None, :, None, None]
            + la[None, None, :, None] + mask[None, None, None, :])
    flat = loge.reshape(len(cross), -1)
    p = np.exp(flat - flat.max(1, keepdims=True))
    p = np.where(p >= c_sig, p, 0.0)
    post = p / p.sum(1, keepdims=True)
    return float((post.reshape(r2.shape) * r2).sum())


@pytest.mark.parametrize("student_df", [None, 6.0])
@pytest.mark.parametrize("c_sig,psi_step", [(0.0, None), (1e-6, 20.0)])
def test_e_step_matches_the_reference(terms, student_df, c_sig, psi_step):
    _, trials, (cj, ej, rj), (ct, et, rt) = terms
    A = cj.shape[-1]
    la = np.log([0.3, 0.2, 0.3, 0.2]).astype(np.float32)
    mask = tml._psi_log_mask(A, psi_step, None)
    s2 = float(ej.mean() / 104.0)
    kw = dict(top_k=8, c_sig=c_sig, student_df=student_df)
    want = jml._e_step(jnp.asarray(cj), jnp.asarray(ej), jnp.asarray(rj),
                       jnp.asarray(trials), jnp.asarray(la), s2, 4.0, 104.0,
                       log_psi_mask=None if mask is None
                       else jnp.asarray(mask), **kw)
    got = tml._e_step(ct, et, rt, trials, la, s2, 4.0, 104.0,
                      log_psi_mask=mask, **kw)
    wk_j, ik_j, frac_j, r2_j, t2_j, ll_j = (np.asarray(a) for a in want)
    wk_t, ik_t, frac_t, r2_t, t2_t, ll_t = (a.numpy() for a in got)
    assert np.abs(wk_t - wk_j).max() <= 1e-4
    big = wk_j > 1e-3
    assert np.array_equal(ik_t[big], ik_j[big])
    assert rel_err(frac_t, frac_j) <= 1e-4
    assert rel_err(t2_t, t2_j) <= 1e-4
    assert rel_err(ll_t, ll_j) <= 1e-4
    assert rel_err(r2_t, r2_j) <= 1e-3
    if student_df is None:
        f64 = _f64_resid2_sum(cj, ej, rj, trials, la, s2, 4.0,
                              np.zeros(A) if mask is None else mask, c_sig)
        assert abs(float(r2_t) - f64) <= 1e-6 * abs(f64)


@pytest.mark.parametrize("mirror", [False, True])
def test_m_step_matches_the_reference(terms, mirror):
    imgs, trials, (cj, ej, rj), _ = terms
    n_refs = 2
    n_cls = 2 * n_refs if mirror else n_refs
    cj, rj = cj[:, :, :n_cls], rj[:n_cls]
    la = np.full(n_cls, -np.log(n_cls), np.float32)
    wk, ik = jml._e_step(jnp.asarray(cj), jnp.asarray(ej), jnp.asarray(rj),
                         jnp.asarray(trials), jnp.asarray(la), 0.05, 4.0,
                         104.0, 8)[:2]
    A = cj.shape[-1]
    want = jml._m_step(jnp.asarray(imgs), wk, ik, jnp.asarray(trials),
                       n_refs, A, mirror)
    got = tml._m_step(torch.as_tensor(imgs), torch.as_tensor(np.array(wk)),
                      torch.as_tensor(np.array(ik)).long(), trials, n_refs,
                      A, mirror)
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1.0)


def test_noise_spectra_and_gray_fit_match_the_reference(terms):
    imgs = terms[0]
    rng = np.random.default_rng(7)
    refs = imgs[:3] + 0.05
    B = len(imgs)
    best = rng.integers(0, 3, B).astype(np.int32)
    psi = rng.uniform(-180, 180, B).astype(np.float32)
    sx, sy = rng.uniform(-2, 2, (2, B)).astype(np.float32)
    flip = rng.uniform(size=B) < 0.5
    args = (refs, imgs, best, psi, sx, sy, flip)
    want = np.asarray(jml._ring_noise_spectra(
        *(jnp.asarray(a) for a in args), RMIN, RMAX))
    tens = [torch.as_tensor(a) for a in args]
    tens[2] = tens[2].long()
    got = tml._ring_noise_spectra(*tens, RMIN, RMAX)
    assert rel_err(got, want) <= 1e-4
    ja, jb = jml._fit_gray(jnp.asarray(imgs), *(jnp.asarray(a)
                                                for a in (refs, best, psi,
                                                          sx, sy, flip)))
    ta, tb = tml._fit_gray(tens[1], tens[0], *tens[2:])
    assert rel_err(ta, np.asarray(ja)) <= 1e-4
    assert rel_err(tb, np.asarray(jb)) <= 1e-4


def test_ml2d_loglike_history_matches_the_reference():
    imgs, labels = four_class_set()
    rj = jml.ml2d(imgs, 4, n_iters=4, max_shift=2, seed=0)
    rt = tml.ml2d(imgs, 4, n_iters=4, max_shift=2, seed=0, device="cpu")
    llj, llt = np.array(rj["loglike"]), np.array(rt["loglike"])
    assert len(llt) == len(llj) == 4
    assert (np.abs(llt - llj) / np.abs(llj)).max() <= 1e-4
    assert np.array_equal(rt["assignments"], rj["assignments"])
    assert rel_err(rt["refs"], rj["refs"]) <= 1e-3
    assert rt["sigma"] == pytest.approx(rj["sigma"], rel=1e-3)
    assert np.abs(rt["fractions"] - rj["fractions"]).max() <= 1e-4


@pytest.mark.parametrize("kw", [
    {"mirror": True}, {"student_df": 6.0}, {"psi_step": 20.0,
                                            "search_rot": 90.0},
    {"c_significance": 1e-6}, {"fourier_noise_model": True},
    {"norm": True}, {"kstest": True}], ids=lambda kw: "-".join(kw))
def test_ml2d_options_match_the_reference(kw):
    imgs, _, _ = _mirror_dataset(n=16)
    rj = jml.ml2d(imgs, 2, n_iters=3, max_shift=2, seed=0, **kw)
    rt = tml.ml2d(imgs, 2, n_iters=3, max_shift=2, seed=0, device="cpu",
                  **kw)
    llj, llt = np.array(rj["loglike"]), np.array(rt["loglike"])
    assert len(llt) == len(llj)
    assert (np.abs(llt - llj) / np.abs(llj)).max() <= 5e-4
    assert float((rt["assignments"] == rj["assignments"]).mean()) >= 0.9
    assert rel_err(rt["refs"], rj["refs"]) <= 1e-2
    if kw.get("mirror"):
        assert float((rt["flip"] == rj["flip"]).mean()) >= 0.9
    if kw.get("norm"):
        assert rel_err(rt["gray_a"], rj["gray_a"]) <= 1e-2
    if kw.get("kstest"):
        assert np.allclose(rt["kstest"], rj["kstest"], atol=1e-2)


def test_mirror_splits_and_registers():
    imgs, is_flip, tmpl = _mirror_dataset()
    res = tml.ml2d(imgs, 1, n_iters=6, max_shift=2, mirror=True, seed=0,
                   device="cpu")
    fl = res["flip"]
    assert max((fl == is_flip).mean(), (fl != is_flip).mean()) > 0.9
    mir = centered_flip(torch.as_tensor(tmpl[None]), -1)[0].numpy()
    ref = res["refs"][0].ravel()
    assert max(np.corrcoef(ref, tmpl.ravel())[0, 1],
               np.corrcoef(ref, mir.ravel())[0, 1]) > 0.9


def test_student_t_monotone():
    imgs, _, _ = _mirror_dataset(n=16)
    ll = tml.ml2d(imgs, 2, n_iters=4, max_shift=2, student_df=6,
                  device="cpu")["loglike"]
    assert all(b >= a - 1e-3 * abs(a) for a, b in zip(ll, ll[1:]))


def test_psi_mask_matches_the_reference():
    for A, ps, sr in ((128, 45.0, None), (128, None, 30.0), (512, 10.0, 60.0),
                      (128, None, None)):
        want = jml._psi_log_mask(A, ps, sr)
        got = tml._psi_log_mask(A, ps, sr)
        if want is None:
            assert got is None
        else:
            assert np.array_equal(np.isfinite(np.asarray(want)),
                                  np.isfinite(got))


def test_iem_updates_the_model_after_each_block():
    imgs, _, _ = _mirror_dataset(n=18)
    ll = tml.ml2d(imgs, 2, n_iters=3, max_shift=2, iem_blocks=3,
                  device="cpu")["loglike"]
    assert len(ll) == 3 and ll[-1] > ll[0]
    one = tml.ml2d(imgs, 2, n_iters=3, max_shift=2, iem_blocks=1,
                   device="cpu")["loglike"]
    plain = jml.ml2d(imgs, 2, n_iters=3, max_shift=2)["loglike"]
    assert (np.abs(np.array(one) - plain) / np.abs(plain)).max() <= 1e-4
    with pytest.raises(ValueError, match="mutually exclusive"):
        tml.ml2d(imgs, 2, n_iters=1, iem_blocks=2, mesh=object(),
                 device="cpu")


def test_fix_flags_and_init():
    imgs, _, tmpl = _mirror_dataset(n=12)
    res = tml.ml2d(imgs, 2, n_iters=2, max_shift=2, sigma_init=1.5,
                   offset_sigma=2.5, fix_sigma_noise=True,
                   fix_sigma_offset=True, fix_fractions=True, device="cpu")
    assert res["sigma"] == pytest.approx(1.5)
    assert res["sigma_offset"] == pytest.approx(2.5)
    assert np.allclose(res["fractions"], 0.5)
    res = tml.ml2d(imgs, 4, n_iters=1, max_shift=2, refs_init=tmpl[None],
                   fractions_init=np.array([1.0]), device="cpu")
    assert len(res["refs"]) == 1
    with pytest.raises(ValueError):
        tml.ml2d(imgs, 2, n_iters=1, refs_init=np.stack([tmpl, tmpl]),
                 fractions_init=np.array([1.0, 1.0, 1.0]), device="cpu")


def test_norm_recovers_gray_scale():
    imgs, _, _ = _mirror_dataset(n=12, noise=0.02)
    scale = np.linspace(0.5, 2.0, 12).astype(np.float32)
    res = tml.ml2d(imgs * scale[:, None, None] + 0.3, 1, n_iters=4,
                   max_shift=2, norm=True, device="cpu")
    ratio = res["gray_a"] / scale
    assert ratio.std() / ratio.mean() < 0.2


def test_chunks_change_no_result(monkeypatch):
    imgs, _ = four_class_set(B=20)
    a = tml.ml2d(imgs, 3, n_iters=2, max_shift=2, device="cpu")
    monkeypatch.setattr(tml, "ESTEP_CHUNK", 7)
    b = tml.ml2d(imgs, 3, n_iters=2, max_shift=2, device="cpu")
    assert np.array_equal(a["assignments"], b["assignments"])
    assert rel_err(b["refs"], a["refs"]) <= 1e-5
    assert np.allclose(a["loglike"], b["loglike"], rtol=1e-6)


def test_ml2d_mesh_dp_over_two_ranks_matches_serial(tmp_path):
    imgs, _ = four_class_set(B=25)          # odd: the mesh pads a row
    stk = str(tmp_path / "parts.mrcs")
    save_image(stk, imgs)
    args = ["-i", stk, "--nref", "4", "--iter", "4", "--maxShift", "2",
            "--mirror"]
    serial = str(tmp_path / "serial")
    assert get_program("ml_align2d").run_with_args(
        args + ["--oroot", serial, "--device", "cpu", "-v", "0"]) == 0
    mesh = str(tmp_path / "mesh")
    reps = Ranks(2, [{"name": "ml2d", "program": "ml_align2d",
                      "argv": args + ["--oroot", mesh, "--mesh", "dp"]}],
                 tmp_path, {}).join()
    for rep in reps:
        assert rep["jobs"]["ml2d"].get("rc") == 0, rep["jobs"]["ml2d"]
        assert rep["modules"] == []
    assert reps[0]["jobs"]["ml2d"]["writes"] >= 1
    assert reps[1]["jobs"]["ml2d"]["writes"] == 0
    ref_s = Image.read_stack(serial + "_references.stk")
    ref_m = Image.read_stack(mesh + "_references.stk")
    assert np.abs(ref_m - ref_s).max() <= 1e-3 * np.abs(ref_s).max()
    cs, cm = (MetaData(r + "_classes.xmd").getColumn("weight")
              for r in (serial, mesh))
    assert np.abs(cm - cs).max() <= 1e-4
    assert np.array_equal(MetaData(serial + "_images.xmd").getColumn("ref"),
                          MetaData(mesh + "_images.xmd").getColumn("ref"))
