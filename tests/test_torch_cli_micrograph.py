"""The micrograph programs (micrograph_programs) against the reference
package's on the same files, on the CPU: two 256^2 micrographs, each with
8 views of the 8-blob phantom (N=32) at planted positions 80 px apart and
noise (numpy draws), the port with --device cpu; its grammar.

Tolerances:
- micrograph_scissor: equal (a host crop in both), with --extractNoise's
  numpy draws, --invert --log and --fillBorders;
- micrograph_automatic_picking, the default path (with --ref and
  without): the same picks in the same order (the greedy peak loop on
  score maps that agree to 1e-5 of their max; no two peaks tie here), the
  costs 1e-5 relative to the largest;
- --trainSVM: each model's weights 1e-4 of their max (float32 Adam in
  both, tests/test_torch_svm_optim.py), the naive Bayes 1e-5 relative
  (float64 statistics of features that agree to 1e-5), the training
  accuracy equal; --svm (with --fastBayes): the same picks;
- the mode protocol: buildinv's invariants 1e-4 of their max (the polar
  resampling and ring spectra of the filter bank's boxes; the raw boxes
  and the average equal); train's PCA mean 1e-4, its basis 1e-3 up to
  each vector's sign (an SVD of the invariants), the templates 1e-3 up to
  sign, the training accuracy equal; autoselect and try on the other
  micrograph: the same picks, the costs 1e-3 absolute (decisions of
  RBF SVMs whose weights agree to 1e-4); the port finds at least 6 of the
  8 planted particles within a quarter box.
"""
import numpy as np
import pytest
import torch

from test_torch_cli_analysis import both, rows, vol
from test_torch_project import phantom8
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.project import FourierProjector
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)

N, M = 32, 256
NEW = ["micrograph_scissor", "micrograph_automatic_picking"]
NEW_ALIASES = []
POS = [(48, 48), (128, 48), (208, 48), (48, 128), (208, 128), (48, 208),
       (128, 208), (208, 208)]


def micrograph(views, noise, seed):
    rng = np.random.default_rng(seed)
    mic = np.zeros((M, M), np.float32)
    for (x, y), v in zip(POS, views):
        mic[y - N // 2:y + N // 2, x - N // 2:x + N // 2] += v
    return (mic + noise * views.std() * rng.standard_normal(mic.shape)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("micrograph")
    for t in "jt":
        (d / t).mkdir()
    rng = np.random.default_rng(17)
    rot = rng.uniform(0, 360, 17).astype(np.float32)
    tilt = rng.uniform(0, 180, 17).astype(np.float32)
    psi = rng.uniform(0, 360, 17).astype(np.float32)
    P = FourierProjector(phantom8(N), device="cpu").project_euler(
        rot, tilt, psi).numpy()
    save_image(str(d / "mic1.mrc"), micrograph(P[:8], 0.5, 1))
    save_image(str(d / "mic2.mrc"), micrograph(P[8:16], 0.5, 2))
    save_image(str(d / "ref.mrcs"), P[16:17])
    MetaData.fromRows({"xcoor": x, "ycoor": y} for x, y in POS).write(
        str(d / "mic1.pos"))
    return d


def picks(path):
    return [(int(r["xcoor"]), int(r["ycoor"])) for r in rows(path)]


def found(got, box=N):
    return sum(any(np.hypot(x - px, y - py) <= box / 4 for x, y in got)
               for px, py in POS)


# -- micrograph_scissor ------------------------------------------------------

@pytest.mark.parametrize("flags", [
    [], ["--invert", "--log"], ["--fillBorders", "--Ydim", "40"],
    ["--extractNoise", "5"]])
def test_micrograph_scissor_matches_the_reference(data, flags):
    d = data
    tag = "_".join(f.strip("-") for f in flags) or "plain"
    for t in "jt":       # --extractNoise rewrites the coordinates file
        MetaData.fromRows({"xcoor": x, "ycoor": y} for x, y in POS).write(
            str(d / t / f"{tag}.pos"))
    both("micrograph_scissor", lambda t: [
        "-i", str(d / "mic1.mrc"), "--pos", str(d / t / f"{tag}.pos"),
        "-o", str(d / t / f"parts_{tag}.stk"), "--Xdim", str(N)] + flags,
        device=False)
    np.testing.assert_array_equal(vol(d / "t" / f"parts_{tag}.stk"),
                                  vol(d / "j" / f"parts_{tag}.stk"))
    got, want = rows(d / "t" / f"parts_{tag}.xmd"), \
        rows(d / "j" / f"parts_{tag}.xmd")
    strip = lambda rs: [{k: v for k, v in r.items() if k != "image"}
                        for r in rs]
    assert strip(got) == strip(want)
    assert picks(d / "t" / f"{tag}.pos") == picks(d / "j" / f"{tag}.pos")


# -- the default picking path --------------------------------------------------

@pytest.mark.parametrize("with_ref", [True, False])
def test_picking_matches_the_reference(data, with_ref):
    d = data
    tag = "ref" if with_ref else "blob"
    both("micrograph_automatic_picking", lambda t: [
        "-i", str(d / "mic1.mrc"), "-o", str(d / t / f"pick_{tag}.pos"),
        "--particleSize", str(N), "--thr", "2"]
        + (["--ref", str(d / "ref.mrcs")] if with_ref else []))
    got, want = rows(d / "t" / f"pick_{tag}.pos"), \
        rows(d / "j" / f"pick_{tag}.pos")
    assert picks(d / "t" / f"pick_{tag}.pos") == \
        picks(d / "j" / f"pick_{tag}.pos")
    cost = lambda rs: np.array([r["cost"] for r in rs])
    np.testing.assert_allclose(cost(got), cost(want), rtol=0,
                               atol=1e-5 * np.abs(cost(want)).max())
    if with_ref:
        assert found(picks(d / "t" / f"pick_{tag}.pos")) >= 6


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_train_svm_and_pick_with_it_match_the_reference(data, kernel):
    d = data
    # positives at the planted positions, negatives between them
    neg = [(88, 88), (168, 88), (88, 168), (168, 168), (128, 128),
           (20, 128), (236, 128), (128, 20)]
    for name, coords in (("pos", POS), ("neg", neg)):
        MetaData.fromRows({"xcoor": x, "ycoor": y} for x, y in coords) \
            .write(str(d / f"train_{name}.pos"))
        assert get_program("micrograph_scissor").run_with_args(
            ["-i", str(d / "mic1.mrc"), "--pos", str(d / f"train_{name}.pos"),
             "-o", str(d / f"train_{name}.stk"), "--Xdim", str(N),
             "-v", "0"]) == 0
    j, t = both("micrograph_automatic_picking", lambda t: [
        "-i", str(d / "mic1.mrc"), "--particleSize", str(N), "--trainSVM",
        "--kernel", kernel, "--fastBayes",
        "--trainPos", str(d / "train_pos.xmd"),
        "--trainNeg", str(d / "train_neg.xmd"),
        "--svm", str(d / t / f"model_{kernel}")])
    assert t.train_accuracy == j.train_accuracy
    zt = np.load(d / "t" / f"model_{kernel}.npz")
    zj = np.load(d / "j" / f"model_{kernel}.npz")
    w = np.append(zt["w"], zt["b" if kernel == "linear" else "bias"])
    wj = np.append(zj["w"], zj["b" if kernel == "linear" else "bias"])
    assert np.abs(w - wj).max() <= 1e-4 * np.abs(wj).max()
    nt = np.load(d / "t" / f"model_{kernel}_nb.npz")
    nj = np.load(d / "j" / f"model_{kernel}_nb.npz")
    for k in ("means", "vars"):
        np.testing.assert_allclose(nt[k], nj[k], rtol=1e-5)
    both("micrograph_automatic_picking", lambda t: [
        "-i", str(d / "mic2.mrc"), "-o", str(d / t / f"svm_{kernel}.pos"),
        "--particleSize", str(N), "--thr", "1.5", "--ref",
        str(d / "ref.mrcs"), "--svm", str(d / t / f"model_{kernel}")])
    assert picks(d / "t" / f"svm_{kernel}.pos") == \
        picks(d / "j" / f"svm_{kernel}.pos")


# -- the mode protocol -----------------------------------------------------------

def test_mode_protocol_matches_the_reference(data):
    d = data
    model = lambda t: str(d / t / "model")
    both("micrograph_automatic_picking", lambda t: [
        "-i", str(d / "mic1.mrc"), "--particleSize", str(N), "--mode",
        "buildinv", str(d / "mic1.pos"), "--model", model(t)])
    zt, zj = (np.load(d / t / "model_training.npz") for t in "tj")
    for k in ("inv_pos", "inv_neg"):
        assert zt[k].shape == zj[k].shape
        assert np.abs(zt[k] - zj[k]).max() <= 1e-4 * np.abs(zj[k]).max(), k
    for k in ("avg_sum", "avg_n", "reservoir"):
        np.testing.assert_array_equal(zt[k], zj[k])
    j, t = both("micrograph_automatic_picking", lambda t: [
        "-i", str(d / "mic1.mrc"), "--particleSize", str(N), "--mode",
        "train", "--model", model(t), "--outputRoot", str(d / t / "out")])
    assert t.train_accuracy == j.train_accuracy
    pt, pj = (np.load(d / t / "model_pca.npz") for t in "tj")
    assert np.abs(pt["mean"] - pj["mean"]).max() \
        <= 1e-4 * np.abs(pj["mean"]).max()
    for k in ("basis", "templates"):
        a, b = pt[k].reshape(-1, pt[k].shape[-1]), \
            pj[k].reshape(-1, pj[k].shape[-1])
        s = np.sign((a * b).sum(axis=1, keepdims=True))
        assert np.abs(a * s - b).max() <= 1e-3 * np.abs(b).max(), k
    for mode in ("autoselect", "try"):
        both("micrograph_automatic_picking", lambda t: [
            "-i", str(d / "mic2.mrc"), "--particleSize", str(N), "--mode",
            mode, "--model", model(t), "--outputRoot",
            str(d / t / f"auto_{mode}")])
        got = rows(f"particles_auto@{d / 't' / f'auto_{mode}'}.pos")
        want = rows(f"particles_auto@{d / 'j' / f'auto_{mode}'}.pos")
        assert [(r["xcoor"], r["ycoor"]) for r in got] == \
            [(r["xcoor"], r["ycoor"]) for r in want]
        np.testing.assert_allclose([r["cost"] for r in got],
                                   [r["cost"] for r in want], atol=1e-3)
    assert (d / "t" / "auto_try_auto_feature_vectors.txt").is_file()
