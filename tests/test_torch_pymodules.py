"""The port's xmippPyModules tree (xmipp3_tpu_torch/binding/xmippPyModules)
against the root xmippPyModules, the JAX package's, on the CPU.

Inputs are made with numpy from seeds at N=32. The port runs with
device="cpu". Tolerances, as a share of the max of the JAX side's output:
the warps, the CTF image and the band vectors 1e-5 (bilinear) and 1e-4
(B-spline); the PCA coordinates of the classification 1e-4 up to each
axis's sign, with the same labels; the match's labels exact and its
distances 1e-5; metadata, coordinates and the host numpy modules exact.
"""
import importlib
import pkgutil

import numpy as np
import pandas as pd
import pytest
import torch

import xmippPyModules
from test_torch_common import rel_err
from xmipp3_tpu_torch.binding import xmippPyModules as port_pymodules

torch.set_num_threads(1)
N = 32
CPU = "cpu"
PORT = "xmipp3_tpu_torch.binding.xmippPyModules"


def module_names(pkg):
    return sorted(m.name[len(pkg.__name__):] for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + "."))


ROOT_MODULES = module_names(xmippPyModules)


def both(sub):
    """(root module, port module) of `xmippPyModules<sub>`."""
    return (importlib.import_module("xmippPyModules" + sub),
            importlib.import_module(PORT + sub))


def test_the_port_has_the_root_tree():
    assert ROOT_MODULES == module_names(port_pymodules)
    assert len(ROOT_MODULES) >= 40


@pytest.mark.parametrize("sub", [""] + ROOT_MODULES)
def test_every_public_name_is_ported(sub):
    for s in ROOT_MODULES:        # subpackages gain their submodules
        both(s)
    root, port = both(sub)
    public = lambda m: {n for n in dir(m) if not n.startswith("_")}
    missing = public(root) - public(port)
    assert not missing, sorted(missing)


def views(seed, count, n=N):
    """Smooth random images (content below a quarter of Nyquist)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((count, n, n))
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    keep = np.sqrt(fy * fy + fx * fx) < 0.125
    return np.fft.irfft2(np.fft.rfft2(x) * keep, s=(n, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# swiftalign
# ---------------------------------------------------------------------------

def test_swiftalign_metadata_and_image(tmp_path):
    jm, tm = both(".swiftalign.metadata")
    ji, ti = both(".swiftalign.image")
    df = pd.DataFrame({"image": ["000002@s.stk", "000001@r.stk"],
                       "anglePsi": [10.0, -20.0], "ref": [1, 2]})
    for w, r, tag in ((tm.write, jm.read, "t"), (jm.write, tm.read, "j")):
        fn = str(tmp_path / f"{tag}.xmd")
        w(df, fn, table="particles")
        back = r(fn, table="particles")
        assert back.equals(r(fn)) and list(back["image"]) == list(df["image"])
        assert np.array_equal(back["anglePsi"], df["anglePsi"])
    assert (tmp_path / "t.xmd").read_text() == (tmp_path / "j.xmd").read_text()
    assert tm.sort_by_image_filename(df).equals(jm.sort_by_image_filename(df))
    with pytest.raises(KeyError):
        tm.read(str(tmp_path / "t.xmd"), table="none")
    labels = [n for n in dir(jm) if n.isupper()]
    assert labels and all(getattr(tm, n) == getattr(jm, n) for n in labels)
    stk = views(0, 3)
    fn = str(tmp_path / "s.mrcs")
    ti.write(stk, fn)
    paths = [f"{i + 1:06d}@{fn}" for i in range(3)]
    assert np.array_equal(ti.read_data(paths), ji.read_data(paths))
    assert np.array_equal(ti.read(paths[1]), ji.read(paths[1]))
    p = ti.parse_path(paths[2])
    assert (p.position_in_stack, p.filename) == (3, fn)
    assert str(p) == str(ji.parse_path(paths[2])) == paths[2]


def test_swiftalign_fourier_operators_utils(capsys):
    jf, tf = both(".swiftalign.fourier")
    assert np.array_equal(tf.rfftnfreq((6, 8), 0.5), jf.rfftnfreq((6, 8), 0.5))
    x = views(1, 2)
    assert np.array_equal(tf.zero_pad(x, (40, 36)), jf.zero_pad(x, (40, 36)))
    jo, to = both(".swiftalign.operators")
    mask = np.hypot(*np.mgrid[-16:16, -16:16]) < 12
    a, b = to.MaskFlattener(mask), jo.MaskFlattener(mask)
    assert a.output_size == b.output_size
    assert np.array_equal(a(x), b(x))
    assert np.array_equal(a.unflatten(a(x)), b.unflatten(b(x)))
    ju, tu = both(".swiftalign.utils")
    ct, cj = tu.LruCache(2), ju.LruCache(2)
    for c in (ct, cj):
        for k in "abca":
            c.put(k, k.upper())
            c.get("a")
    assert len(ct) == len(cj) and ("b" in ct) == ("b" in cj)
    assert list(tu.progress_bar(range(3))) == list(ju.progress_bar(range(3)))


def test_swiftalign_transform():
    jt, tt = both(".swiftalign.transform")
    rot, tilt, psi = [10.0, 200.0], [20.0, 135.0], [30.0, -45.0]
    M = tt.euler_to_matrix(rot, tilt, psi)
    assert np.abs(M - jt.euler_to_matrix(rot, tilt, psi)).max() <= 1e-6
    for a, b in zip(tt.matrix_to_euler(M), jt.matrix_to_euler(M)):
        assert np.abs(a - b).max() <= 1e-6
    q = tt.euler_to_quaternion(rot, tilt, psi)
    assert np.array_equal(q, jt.euler_to_quaternion(rot, tilt, psi))
    assert np.array_equal(tt.quaternion_to_matrix(q),
                          jt.quaternion_to_matrix(q))
    assert np.array_equal(tt.quaternion_product(q, tt.quaternion_conj(q)),
                          jt.quaternion_product(q, jt.quaternion_conj(q)))
    ang, sh = [15.0, -70.0, 120.0], [[1.0, -2.0], [0.5, 0.0], [-1.5, 2.5]]
    A = tt.affine_matrix_2d(ang, sh, scale=1.1, device=CPU)
    assert np.abs(A - jt.affine_matrix_2d(ang, sh, scale=1.1)).max() <= 1e-6
    x = views(2, 3)
    for interp, tol in (("bilinear", 1e-5), ("bicubic", 1e-4)):
        want = jt.affine_2d(x, A, interpolation=interp)
        got = tt.affine_2d(x, A[:, :2, :], interpolation=interp, device=CPU)
        assert rel_err(got, want) <= tol
    out = np.empty_like(x)
    assert tt.affine_2d(x, A, device=CPU, out=out) is out
    assert rel_err(out, jt.affine_2d(x, A)) <= 1e-5


def test_swiftalign_ctf_and_alignment():
    jc, tc = both(".swiftalign.ctf")
    args = (15000.0, 14000.0, 30.0, N, 1.5)
    want = jc.compute_ctf_image_2d(*args, phase_shift=0.2)
    got = tc.compute_ctf_image_2d(*args, phase_shift=0.2, device=CPU)
    assert got.shape == (N, N // 2 + 1) and rel_err(got, want) <= 1e-5
    for ssnr in (None, 0.05):
        assert np.array_equal(tc.wiener_2d(got, ssnr), jc.wiener_2d(got, ssnr))
    out = np.empty_like(got)
    assert tc.wiener_2d(got, None, out) is out
    ja, ta = both(".swiftalign.alignment")
    x = views(3, 4)
    psi, sx, sy = [0.0, 30.0, -100.0, 250.0], [0, 1.5, -2, 0.5], [0, -1, 2, 3]
    flip = [False, True, False, True]
    for interp, tol in (("bilinear", 1e-5), ("bicubic", 1e-4)):
        want = ja.InPlaneTransformCorrector(interp)(x, psi, sx, sy, flip)
        got = ta.InPlaneTransformCorrector(interp, device=CPU)(x, psi, sx,
                                                              sy, flip)
        assert rel_err(got, want) <= tol


def class_views(seed, per=12):
    """Two well-separated classes of noisy images."""
    rng = np.random.default_rng(seed)
    base = views(seed + 100, 2)
    lab = np.repeat([0, 1], per)
    return (base[lab] + 0.2 * rng.standard_normal((2 * per, N, N))
            .astype(np.float32)), lab


def test_swiftalign_classification():
    jc, tc = both(".swiftalign.classification")
    x, truth = class_views(4)
    mask = np.hypot(*np.mgrid[-16:16, -16:16]) < 14
    for m in (None, mask):
        lj, aj, yj = jc.aligned_2d_classification(x, m, seed=1)
        lt, at, yt = tc.aligned_2d_classification(x, m, seed=1, device=CPU)
        assert np.array_equal(lt, lj)
        assert len(set(zip(lt, truth))) == 2          # the classes found
        assert rel_err(at, aj) <= 1e-5
        sign = np.sign((yt * yj).sum(0))
        assert rel_err(yt * sign, yj) <= 1e-4


# ---------------------------------------------------------------------------
# classifyPcaFuntion, coordinatesTools, the rest
# ---------------------------------------------------------------------------

def test_bnb_trial_grid_bands_and_match():
    jb, tb = both(".classifyPcaFuntion.bnb_gpu")
    J, T = jb.BnBgpu(3), tb.BnBgpu(3, device=CPU)
    grid = ((0.0, 360.0, 90.0), (2.0, 2.0))
    assert np.array_equal(T.setRotAndShift(*grid), J.setRotAndShift(*grid))
    x, _ = class_views(5, 8)
    for a, b in zip(T.selectFourierBands(x), J.selectFourierBands(x)):
        assert rel_err(a, b) <= 1e-5
    assert rel_err(T.create_batchExp(x), J.create_batchExp(x)) <= 1e-5
    refs = T.init_ramdon_classes(2, x, seed=3)
    assert np.array_equal(refs, J.init_ramdon_classes(2, x, seed=3))
    ref_t, ref_j = T.precalculate_projection(refs), \
        J.precalculate_projection(refs)
    assert ref_t.shape == ref_j.shape == (2, 36, ref_t.shape[-1])
    assert rel_err(ref_t, ref_j) <= 1e-5
    tb.WARP_BATCH, keep = 7, tb.WARP_BATCH     # the chunked path
    try:
        assert np.array_equal(T.precalculate_projection(refs), ref_t)
    finally:
        tb.WARP_BATCH = keep
    exp = J.create_batchExp(x)
    lt, tt, dt = T.match_batch(exp, ref_j)
    lj, tj, dj = J.match_batch(exp, ref_j)
    assert np.array_equal(lt, lj) and np.array_equal(tt, tj)
    assert rel_err(dt, dj) <= 1e-5


def test_pca_gpu_and_assessment():
    jp, tp = both(".classifyPcaFuntion.pca_gpu")
    rng = np.random.default_rng(6)
    first = rng.standard_normal((20, 5))
    P, Q = tp.PCAgpu(2), jp.PCAgpu(2)
    for a, b in zip(P.first_eigenvector(first, 20),
                    Q.first_eigenvector(first, 20)):
        assert np.array_equal(a, b)
    band = [rng.standard_normal(5) for _ in range(2)]
    mean = [P.mean, P.mean]
    var = [P.var, P.var]
    vecs = [P.vecs[:, :2], P.vecs[:, :2]]
    vals = [P.vals[:2], P.vals[:2]]
    for m in ("mean_update", "var_update"):
        args = (band, mean, 3) if m == "mean_update" else (band, mean, var, 3)
        for a, b in zip(getattr(P, m)(*args), getattr(Q, m)(*args)):
            assert np.array_equal(a, b)
    phi = P.phiProjTrain(band, mean, vecs)
    for a, b in zip(phi, Q.phiProjTrain(band, mean, vecs)):
        assert np.array_equal(a, b)
    for a, b in zip(P.phiProj(band, vecs), Q.phiProj(band, vecs)):
        assert np.array_equal(a, b)
    for a, b in zip(P.eigenvalue_update(vals, phi, 0.1),
                    Q.eigenvalue_update(vals, phi, 0.1)):
        assert np.array_equal(a, b)
    for a, b in zip(P.eigenvector_update(band, vecs, phi, mean, 0.1, [2, 2]),
                    Q.eigenvector_update(band, vecs, phi, mean, 0.1, [2, 2])):
        assert np.array_equal(a, b)
    ja, ta = both(".classifyPcaFuntion.assessment")
    x, lab = class_views(7, 5)
    assert np.array_equal(ta.class_populations(lab, 3),
                          ja.class_populations(lab, 3))
    assert np.array_equal(ta.intra_class_correlation(x, lab),
                          ja.intra_class_correlation(x, lab))


def test_coordinates_tools(tmp_path):
    jc, tc = both(".coordinatesTools")
    pts = [(10.2, 20.7), (33.0, 4.4), (0.0, 63.5)]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ft = tc.writeCoordsListToPosFname("mic_1.mrc", pts, str(tmp_path / "t"),
                                      micId=4)
    fj = jc.writeCoordsListToPosFname("mic_1.mrc", pts, str(tmp_path / "j"),
                                      micId=4)
    assert open(ft).read() == open(fj).read()
    assert tc.readPosCoordsFromFName(fj, True) == \
        jc.readPosCoordsFromFName(ft, True) == ([(10, 21), (33, 4), (0, 64)],
                                                4)
    assert tc.readPosCoordsFromFName(ft) == jc.readPosCoordsFromFName(ft)


def test_deep_toolkit_and_examples(monkeypatch):
    _, tu = both(".deepLearningToolkitUtils.utils")
    assert tu.checkIf_tf_keras_installed() and tu.checkIf_pytorch_installed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tu.getDeviceInfo() == {"platform": "cpu", "device_count": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    assert tu.getDeviceInfo() == {"platform": "gpu", "device_count": 1,
                                  "name": "card"}
    je, te = both(".example_module")
    assert te.anyFunction() == je.anyFunction()
    assert te.axis_angle_example() == je.axis_angle_example()
    assert te.anyClass.getFromClassMethod() == je.anyClass.getFromClassMethod()
    assert te.anyClass().getFromObjectMethod() == \
        je.anyClass().getFromObjectMethod()
    je, te = both(".example_module2.example_inmodule2")
    assert te.anyFunction2() == je.anyFunction2()
    assert te.anyClass2.getFromClassMethod2() == \
        je.anyClass2.getFromClassMethod2()
    assert te.anyClass2().getFromObjectMethod2() == \
        je.anyClass2().getFromObjectMethod2()


def test_card_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tb = both(".classifyPcaFuntion.bnb_gpu")
    _, tt = both(".swiftalign.transform")
    _, tc = both(".swiftalign.ctf")
    _, tcl = both(".swiftalign.classification")
    x = views(8, 3)
    for call in (lambda: tb.BnBgpu(2),
                 lambda: tt.affine_matrix_2d([10.0]),
                 lambda: tt.affine_2d(x, np.eye(3)),
                 lambda: tc.compute_ctf_image_2d(1e4, 1e4, 0, 16, 2.0),
                 lambda: tcl.aligned_2d_classification(x)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
