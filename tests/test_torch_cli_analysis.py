"""The image- and class-analysis programs (image_analysis and
classify_analysis) against the reference package's on the same files, on
the CPU (N=32, the 8-blob phantom, 24 noisy views at known poses), the
port with --device cpu; the reference's 6 aliases of them and its grammar;
the flags the reference declares and never reads, and the matrix_dimred
sub-arguments it drops, which the port refuses.

Tolerances, relative to the max of the reference's output where not said:
- image_vectorize, classify_compare_classes, image_eliminate_byEnergy,
  run: equal (host work, or float32 statistics far from the thresholds);
- image_sort: the same chain for at least the first 3/4 of its steps
  (read: 19 of 24), with maxCC 1e-4 and the aligned images 1e-3 there.
  A chain feeds each aligned image back as the next reference, so one
  alignment that lands on another branch ends the agreement: at step 20
  the port aligns one view at 0.956 where the reference's alignment of it
  stays below the 0.9475 of the view it takes;
- image_sort_by_statistics: z-scores 1e-4, the same order and enabled
  flags; image_ssnr: SSNR 1e-4 dB-relative, the same flags;
  image_eliminate_empty_particles: scores 1e-4, the same split;
  image_find_center: the same center (a grid search, argmin of float32
  energies far apart);
- matrix_dimred: embeddings up to each axis's sign, 1e-6 (float64 on both
  sides; the eigen solvers differ), the estimated dimension equal, the
  linear mapping 1e-6;
- image_rotational_pca: the basis 1e-3 after the sign rule on the exact
  SVD path, and on the randomised sketch (float64 on both sides) each
  principal angle between the two bases below 1e-3 rad;
- classify_evaluate_classes: resolutions 1e-4 relative, counts equal;
  classify_analyze_cluster: z-scores and the basis 1e-4 (EM-PCA's float32
  products), the same enabled flags;
- classify_extract_features: every extractor 1e-4 of each feature's max
  but the entropies, 1e-3 (read 3.1e-4: the two packages' centrings differ
  by 3e-6 of the max, which moves pixels across the 256 bins' edges; on
  the same input they agree to 1e-7, tests/test_torch_features.py); the
  ring statistics 1e-5. With --applyDenoising the two packages' 200
  float32 SPG steps end 1e-3 apart on [0, 1] images
  (tests/test_torch_features.py holds their energies), so the variance
  features are held to 1e-2 of their max (read 4e-3) and the LBP
  histograms to 0.1 of their count in L1 (read 0.08);
- classify_first_split: the average volume and v1 5e-3 (the
  Kaiser-Bessel tolerance of the port's gridding tests: K3's plain version
  evaluates the window as a polynomial; read 1.3e-3 and 1.6e-3), the
  projections zn 2e-2 (read 1.9e-3); both take the FRM-aligned mirror of
  v2, whose correlation with v1 agrees to 1e-2 (read 0.9067 and 0.9070).
  The v2 volumes themselves differ: the SO(3) grid's top cells lie within
  7e-5 of each other here, so the 1e-3 difference of the inputs picks
  another cell and the polish another nearby rotation (on the same input
  the two FRMs agree, tests/test_torch_frm_helical.py);
- classify_first_split3: at least 0.9 of the views in the same half (the
  swaps sort correlations of the K2 volumes, which differ in roundoff),
  the volumes 1e-4 where the halves agree;
- volume_halves_restoration: every written volume 1e-4 (the sigma fit is
  the same scipy Powell on float32 costs: its sigmas 1e-3);
- volume_find_symmetry: the same axis and helical cell; the helical map
  1e-4; --localRot and --localHelical within 0.05 of the reference;
- denoising_tv: 1e-5.
"""
import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.project import FourierProjector
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

N, B = 32, 24
NEW = ["image_vectorize", "image_sort", "image_sort_by_statistics",
       "image_find_center", "image_ssnr", "image_eliminate_empty_particles",
       "matrix_dimred", "image_rotational_pca", "image_eliminate_byEnergy",
       "classify_evaluate_classes", "classify_analyze_cluster",
       "classify_extract_features", "classify_compare_classes",
       "classify_first_split", "classify_first_split3",
       "volume_halves_restoration", "volume_find_symmetry", "run",
       "denoising_tv"]
NEW_ALIASES = ["mpi_image_eliminate_byEnergy", "mpi_image_rotational_pca",
               "mpi_image_sort", "mpi_image_ssnr", "mpi_run",
               "cuda_volume_halves_restoration"]
MESHED = ("image_rotational_pca", "volume_halves_restoration")


def both(name, args_of, device=True):
    """Run `name` through both dispatchers; args_of(tag) gives each run's
    arguments ("j" for the reference, "t" for the port). Returns the two
    program objects."""
    progs = []
    for tag, get in (("j", jax_program), ("t", get_program)):
        prog = get(name)
        tail = ["-v", "0"] + (["--mesh", "none"] if name in MESHED else []) \
            + (["--device", "cpu"] if tag == "t" and device else [])
        with redirect_stdout(io.StringIO()):
            assert prog.run_with_args(args_of(tag) + tail) == 0, tag
        progs.append(prog)
    return progs


def vol(path):
    return np.squeeze(np.asarray(Image(str(path)).data, np.float64))


def rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def rows(path, block=None):
    md = MetaData(str(path), block=block)
    return [md.getRow(i) for i in md]


def col(rs, k):
    return np.array([float(r[k]) for r in rs])


def aligned(got, want):
    """got's columns with the sign that matches want's."""
    s = np.sign((got * want).sum(axis=0))
    return got * np.where(s == 0, 1, s)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The phantom; 24 noisy views of it at known poses (flips on some,
    three classes); 4 flat noise images appended for the screening
    programs; a two-classification file pair."""
    d = tmp_path_factory.mktemp("analysis")
    for t in "jt":
        (d / t).mkdir()
    v = phantom8(N)
    save_image(str(d / "vol.vol"), v)
    rng = np.random.default_rng(7)
    rot = rng.uniform(0, 360, B).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, B))).astype(np.float32)
    psi = rng.uniform(0, 360, B).astype(np.float32)
    P = FourierProjector(v, device="cpu").project_euler(rot, tilt, psi) \
        .numpy()
    imgs = (P + 0.3 * P.std() * rng.standard_normal(P.shape)) \
        .astype(np.float32)
    stk = str(d / "views.mrcs")
    save_image(stk, imgs)
    flip = np.arange(B) % 5 == 3
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(rot[i]),
         "angleTilt": float(tilt[i]), "anglePsi": float(psi[i]),
         "shiftX": 0.0, "shiftY": 0.0, "flip": int(flip[i] and False),
         "ref": 1 + i % 3, "itemId": i + 1, "enabled": 1}
        for i in range(B)).write(str(d / "views.xmd"))
    # screening set: the views plus 4 noise-only images
    noise = rng.standard_normal((4, N, N)).astype(np.float32) * P.std()
    scr = str(d / "screen.mrcs")
    save_image(scr, np.concatenate([imgs, noise]))
    MetaData.fromRows({"image": f"{i + 1}@{scr}", "itemId": i + 1}
                      for i in range(B + 4)).write(str(d / "screen.xmd"))
    # two classifications of the views
    for k, split in ((1, [range(0, 10), range(10, 24)]),
                     (2, [range(0, 6), range(6, 18), range(18, 24)])):
        fn = str(d / f"cls{k}.xmd")
        MetaData.fromRows({"ref": j + 1, "classCount": len(s)}
                          for j, s in enumerate(split)).write(fn, "classes")
        for j, s in enumerate(split):
            MetaData.fromRows({"image": f"{i + 1}@{stk}"} for i in s).write(
                fn, f"class{j + 1:06d}_images", append=True)
    return d


# -- image_analysis ---------------------------------------------------------

def test_image_vectorize_round_trip(data, tmp_path):
    d = data
    mask = np.zeros((N, N), np.float32)
    mask[4:28, 6:30] = 1
    save_image(str(d / "vmask.xmp"), mask)
    for extra in ([], ["--mask", str(d / "vmask.xmp")]):
        both("image_vectorize", lambda t: [
            "-i", str(d / "views.xmd"), "-o", str(d / t / "vec.xmd"),
            *extra], device=False)
        want, got = rows(d / "j" / "vec.xmd"), rows(d / "t" / "vec.xmd")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["classificationData"],
                                          b["classificationData"])
    both("image_vectorize", lambda t: ["-i", str(d / "j" / "vec.xmd"), "-o",
                                       str(d / t / "back.mrcs")],
         device=False)
    np.testing.assert_array_equal(vol(d / "t" / "back.mrcs"),
                                  vol(d / "j" / "back.mrcs"))


def test_image_sort_follows_the_reference_chain(data):
    d = data
    pj, pt = both("image_sort", lambda t: ["-i", str(d / "views.xmd"),
                                           "--oroot", str(d / t / "sorted")])
    assert sorted(pt.order) == list(range(B))
    n = int(np.argmin(np.array(pt.order) == pj.order)) or B
    assert n >= 0.75 * B
    assert np.abs(np.array(pt.ccs[:n]) - pj.ccs[:n]).max() <= 1e-4
    assert rel(vol(d / "t" / "sorted.stk")[:n],
               vol(d / "j" / "sorted.stk")[:n]) <= 1e-3
    assert [r["imageOriginal"] for r in rows(d / "t" / "sorted.xmd")][:n] \
        == [r["imageOriginal"] for r in rows(d / "j" / "sorted.xmd")][:n]


@pytest.mark.parametrize("extra", [[], ["--percent", "10", "--dim", "16",
                                        "--addFeatures"],
                                   ["--zcut", "2", "-t", "TRAIN",
                                    "--dim", "-1"]])
def test_image_sort_by_statistics_matches_the_reference(data, extra):
    d = data
    extra = [str(d / "views.xmd") if a == "TRAIN" else a for a in extra]
    pj, pt = both("image_sort_by_statistics", lambda t: [
        "-i", str(d / "screen.xmd"), "-o", str(d / t / "stat.xmd"), *extra])
    assert rel(pt.zscores, pj.zscores) <= 1e-4
    got, want = rows(d / "t" / "stat.xmd"), rows(d / "j" / "stat.xmd")
    assert [r["itemId"] for r in got] == [r["itemId"] for r in want]
    assert [r.get("enabled") for r in got] == \
        [r.get("enabled") for r in want]
    if "--addFeatures" in extra:
        assert rel(np.stack([r["scoreByScreening"] for r in got]),
                   np.stack([r["scoreByScreening"] for r in want])) <= 1e-4


@pytest.mark.parametrize("extra", [[], ["--harm", "2", "--opt", "1",
                                        "--x0", "15", "--y0", "17"]])
def test_image_find_center_matches_the_reference(data, tmp_path, extra):
    d = data
    pj, pt = both("image_find_center", lambda t: [
        "-i", str(d / "views.mrcs"), "--oroot", str(d / t / "ctr"), *extra])
    assert pt.center == pj.center
    assert rows(d / "t" / "ctr_center.xmd") == rows(d / "j" /
                                                    "ctr_center.xmd")


@pytest.mark.parametrize("extra", [[], ["--ssnrpercent", "25",
                                        "--normalizessnr", "-R", "10",
                                        "--sampling", "2"]])
def test_image_ssnr_matches_the_reference(data, extra):
    d = data
    pj, pt = both("image_ssnr", lambda t: [
        "-i", str(d / "screen.xmd"), "-o", str(d / t / "ssnr.xmd"), *extra])
    assert rel(pt.ssnr, pj.ssnr) <= 1e-4
    got, want = rows(d / "t" / "ssnr.xmd"), rows(d / "j" / "ssnr.xmd")
    assert col(got, "enabled").tolist() == col(want, "enabled").tolist()
    if "--normalizessnr" in extra:
        assert rel(col(got, "weightSSNR"), col(want, "weightSSNR")) <= 1e-4


@pytest.mark.parametrize("extra", [["-t", "1.1"],
                                   ["-t", "1.1", "--useDenoising", "-d", "12",
                                    "--addFeatures"]])
def test_image_eliminate_empty_particles_matches_the_reference(data, extra):
    d = data
    pj, pt = both("image_eliminate_empty_particles", lambda t: [
        "-i", str(d / "screen.xmd"), "-o", str(d / t / "kept.xmd"), "-e",
        str(d / t / "elim.xmd"), *extra])
    assert rel(pt.ratio, pj.ratio) <= 1e-4
    assert (pt.n_kept, pt.n_eliminated) == (pj.n_kept, pj.n_eliminated)
    for f in ("kept.xmd", "elim.xmd"):
        if (d / "j" / f).exists():
            assert col(rows(d / "t" / f), "itemId").tolist() == \
                col(rows(d / "j" / f), "itemId").tolist()


def test_image_eliminate_by_energy_matches_the_reference(data):
    d = data
    both("image_eliminate_byEnergy", lambda t: [
        "-i", str(d / "screen.xmd"), "-o", str(d / t / "energy.xmd"),
        "--sigma2", "10", "--confidence", "0.9", "--minSigma2", "5"])
    got = col(rows(d / "t" / "energy.xmd"), "itemId").tolist()
    assert 0 < len(got) < B + 4
    assert got == col(rows(d / "j" / "energy.xmd"), "itemId").tolist()


def _swiss(n=60, seed=3):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 3 * np.pi, n)
    return np.stack([np.cos(t) * t, np.sin(t) * t, rng.uniform(0, 4, n),
                     0.05 * rng.standard_normal(n),
                     0.05 * rng.standard_normal(n)], axis=1)


DIMRED = {"PCA": ["--saveMapping", "MAP"], "LTSA": [], "DM": [],
          "LE": ["5", "2"], "pPCA": ["30"], "HLLE": ["9"],
          "LLTSA": ["--saveMapping", "MAP"], "NPE": ["10"],
          "kPCA": ["--dout", "-1", "MLE"], "LPP": [], "LLE": [],
          "Sammon": [], "MLE": None}


@pytest.mark.parametrize("method", [m for m in DIMRED if m != "MLE"])
def test_matrix_dimred_matches_the_reference(data, method):
    d = data
    np.savetxt(str(d / "X.txt"), _swiss())
    extra = DIMRED[method]
    sub = [a for a in extra if not a.startswith("-") and a != "MLE"
           and a != "MAP"]
    flags = [a for a in extra if a not in sub or a == "MLE"]
    pj, pt = both("matrix_dimred", lambda t: [
        "-i", str(d / "X.txt"), "-o", str(d / t / "Y.txt"), "-m", method,
        *sub, *[str(d / t / "M.txt") if a == "MAP" else a for a in flags]])
    Yj, Yt = np.loadtxt(str(d / "j" / "Y.txt")), \
        np.loadtxt(str(d / "t" / "Y.txt"))
    assert Yt.shape == Yj.shape
    assert rel(aligned(Yt, Yj), Yj) <= 1e-6
    if "MAP" in extra:
        Mj, Mt = np.loadtxt(str(d / "j" / "M.txt")), \
            np.loadtxt(str(d / "t" / "M.txt"))
        assert rel(aligned(Mt, Mj), Mj) <= 1e-6


def test_matrix_dimred_on_metadata_vectors(data):
    d = data
    both("image_vectorize", lambda t: ["-i", str(d / "views.xmd"), "-o",
                                       str(d / t / "vec.xmd")], device=False)
    both("matrix_dimred", lambda t: [
        "-i", str(d / "j" / "vec.xmd"), "-o", str(d / t / "dimred.xmd"),
        "-m", "PCA", "--dout", "3"])
    Yj = np.stack([r["dimred"] for r in rows(d / "j" / "dimred.xmd")])
    Yt = np.stack([r["dimred"] for r in rows(d / "t" / "dimred.xmd")])
    assert rel(aligned(Yt, Yj), Yj) <= 1e-5


@pytest.mark.parametrize("args", [["LPP", "5", "2"], ["LPP", "12", "3"],
                                  ["kPCA", "3"], ["SPE", "5", "1"],
                                  ["SPE", "12", "0"], ["LLE", "5"]])
def test_matrix_dimred_refuses_the_sub_arguments_the_reference_drops(
        data, args, capsys):
    d = data
    np.savetxt(str(d / "X.txt"), _swiss())
    assert get_program("matrix_dimred").run_with_args(
        ["-i", str(d / "X.txt"), "-o", str(d / "t" / "no.txt"), "-m",
         *args, "--device", "cpu", "-v", "0"]) == 1
    assert "drops its sub-argument" in capsys.readouterr().err
    assert not (d / "t" / "no.txt").exists()


def _principal_angles(A, B):
    qa = np.linalg.qr(A.reshape(len(A), -1).T)[0]
    qb = np.linalg.qr(B.reshape(len(B), -1).T)[0]
    s = np.clip(np.linalg.svd(qa.T @ qb, compute_uv=False), -1, 1)
    return np.arccos(s)


def test_image_rotational_pca_exact_path_matches_the_reference(data):
    d = data
    both("image_rotational_pca", lambda t: [
        "-i", str(d / "views.xmd"), "--oroot", str(d / t / "rpca"),
        "--eigenvectors", "4", "--psi_step", "30", "--max_shift_change",
        "1", "--shift_step", "1"])
    assert rel(vol(d / "t" / "rpca.stk"), vol(d / "j" / "rpca.stk")) <= 1e-3


def test_image_rotational_pca_sketch_path_spans_the_reference(data):
    """--shuffles 30 over 1,400 images of 32^2 (41.6M values > 4e7): the
    randomised sketch with 2 QR rounds, from the same Generator."""
    d = data
    rng = np.random.default_rng(5)
    big = np.repeat(vol(d / "views.mrcs").astype(np.float32), 59, axis=0)
    big += 0.5 * rng.standard_normal(big.shape).astype(np.float32)
    save_image(str(d / "big.mrcs"), big[:1400])
    both("image_rotational_pca", lambda t: [
        "-i", str(d / "big.mrcs"), "--oroot", str(d / t / "rpcab"),
        "--eigenvectors", "3", "--shuffles", "30"])
    assert _principal_angles(vol(d / "t" / "rpcab.stk"),
                             vol(d / "j" / "rpcab.stk")).max() <= 1e-3


# -- classify_analysis ------------------------------------------------------

def test_classify_evaluate_classes_matches_the_reference(data):
    d = data
    pj, pt = both("classify_evaluate_classes", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / "eval.xmd")])
    assert [m["classCount"] for m in pt.metrics] == \
        [m["classCount"] for m in pj.metrics]
    assert rel([m["resolutionFreqReal"] for m in pt.metrics],
               np.array([m["resolutionFreqReal"] for m in pj.metrics])) \
        <= 1e-4


@pytest.mark.parametrize("extra", [["--basis", "BASIS"],
                                   ["--dontMask", "--NPCA", "3",
                                    "--maxDist", "1.2", "--ref", "REF"]])
def test_classify_analyze_cluster_matches_the_reference(data, extra):
    d = data
    save_image(str(d / "ref.xmp"), vol(d / "views.mrcs")[0]
               .astype(np.float32))
    sub = lambda t: [str(d / t / "basis.stk") if a == "BASIS" else
                     str(d / "ref.xmp") if a == "REF" else a for a in extra]
    pj, pt = both("classify_analyze_cluster", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / "clu.xmd"),
        *sub(t)])
    assert rel(pt.distances, pj.distances) <= 1e-4
    assert col(rows(d / "t" / "clu.xmd"), "enabled").tolist() == \
        col(rows(d / "j" / "clu.xmd"), "enabled").tolist()
    if "BASIS" in extra:
        bj, bt = vol(d / "j" / "basis.stk"), vol(d / "t" / "basis.stk")
        assert rel(bt[:2], bj[:2]) <= 1e-6
        for k in range(2, len(bj)):
            s = np.sign((bt[k] * bj[k]).sum())
            assert rel(s * bt[k], bj[k]) <= 1e-4


FEATS = ["--entropy", "--granulo", "--histdist", "--lbp", "--ramp",
         "--variance", "--zernike"]
LABELS = ["scoreByEntropy", "scoreByGranulo", "scoreByHistDist",
          "scoreByLBP", "scoreByRamp", "scoreByVariance", "scoreByZernike"]


@pytest.mark.parametrize("extra", [FEATS, ["--applyDenoising", "--lbp",
                                           "--variance"], []])
def test_classify_extract_features_matches_the_reference(data, extra):
    d = data
    both("classify_extract_features", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / "feat.xmd"), *extra])
    got, want = rows(d / "t" / "feat.xmd"), rows(d / "j" / "feat.xmd")
    labels = [l for f, l in zip(FEATS, LABELS) if f in extra] or \
        ["classificationData"]
    denoised = "--applyDenoising" in extra
    for lab in labels:
        a = np.stack([r[lab] for r in got]).astype(np.float64)
        b = np.stack([r[lab] for r in want]).astype(np.float64)
        assert np.isfinite(b).all()
        if denoised and lab == "scoreByLBP":
            assert (np.abs(a - b).sum(axis=1) <= 0.1 * b.sum(axis=1)).all()
            continue
        tol = 1e-2 if denoised else 1e-5 if not extra else \
            1e-3 if lab == "scoreByEntropy" else 1e-4
        assert (np.abs(a - b) <= tol * np.abs(b).max(axis=0)).all(), lab


@pytest.mark.parametrize("append", [False, True])
def test_classify_compare_classes_writes_the_reference_report(data, append):
    d = data
    for t in "jt":
        with open(d / t / "cmp.txt", "w") as fh:
            fh.write("before\n")
    pj, pt = both("classify_compare_classes", lambda t: [
        "--i1", str(d / "cls1.xmd"), "--i2", str(d / "cls2.xmd"), "-o",
        str(d / t / "cmp.txt")] + (["--append"] if append else []),
        device=False)
    np.testing.assert_array_equal(pt.comparison_matrix, pj.comparison_matrix)
    assert (d / "t" / "cmp.txt").read_text() == \
        (d / "j" / "cmp.txt").read_text()


def test_classify_first_split_matches_the_reference(data):
    d = data
    pj, pt = both("classify_first_split", lambda t: [
        "-i", str(d / "views.xmd"), "--oroot", str(d / t / "split"),
        "--Nrec", "8", "--Nsamples", "8", "--sym", "c2"])
    assert rel(vol(d / "t" / "split_avg.vol"), vol(d / "j" /
                                                   "split_avg.vol")) <= 5e-3
    # both packages' eigh give the first axis the same sign here
    assert (pt.zn * pj.zn).sum() > 0
    assert rel(pt.zn, pj.zn) <= 2e-2
    assert rel(pt.v1, pj.v1) <= 5e-3
    # v2 is the FRM-aligned mirror in both, equally well aligned
    corr = lambda a, b: np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert abs(corr(pt.v1, pt.v2) - corr(pj.v1, pj.v2)) <= 1e-2


def test_classify_first_split3_matches_the_reference(data):
    d = data
    pj, pt = both("classify_first_split3", lambda t: [
        "-i", str(d / "views.xmd"), "--oroot", str(d / t / "s3"),
        "--Niter", "1500"])
    ij = set(col(rows(d / "j" / "s3_avg1.xmd"), "itemId"))
    it = set(col(rows(d / "t" / "s3_avg1.xmd"), "itemId"))
    same = B - len(ij ^ it)
    assert same >= 0.9 * B
    if ij == it:
        for f in ("s3_avg1.vol", "s3_avg2.vol"):
            assert rel(vol(d / "t" / f), vol(d / "j" / f)) <= 1e-4


@pytest.fixture(scope="module")
def halves(data):
    d = data
    rng = np.random.default_rng(11)
    v = phantom8(N)
    for k in (1, 2):
        save_image(str(d / f"half{k}.vol"), (v + 0.2 * rng.standard_normal(
            v.shape)).astype(np.float32))
    m = np.zeros_like(v)
    m[4:28, 4:28, 4:28] = 1
    save_image(str(d / "hmask.vol"), m)
    return d


HALVES = {
    "all": ["--denoising", "1", "--deconvolution", "1", "0.2", "0.001",
            "--filterBank", "0.05", "0.5", "1", "3", "--difference", "1",
            "1.5", "--mask", "binary_file", "MASK"],
    "bank_fun2": ["--filterBank", "0.1", "0.25", "2", "2"],
    "bank_fun0": ["--filterBank", "0.1", "0.5", "0", "1", "--denoising",
                  "2"],
}


@pytest.mark.parametrize("case", list(HALVES))
def test_volume_halves_restoration_matches_the_reference(halves, case):
    d = halves
    args = [str(d / "hmask.vol") if a == "MASK" else a for a in HALVES[case]]
    both("volume_halves_restoration", lambda t: [
        "--i1", str(d / "half1.vol"), "--i2", str(d / "half2.vol"),
        "--oroot", str(d / t / f"rest_{case}"), *args])
    outs = sorted(f.name for f in (d / "j").glob(f"rest_{case}_*.vol"))
    assert "rest_%s_restored1.vol" % case in outs
    for f in outs:
        assert rel(vol(d / "t" / f), vol(d / "j" / f)) <= 1e-4, f


def _c4_volume(n, rot, tilt):
    """Blobs repeated 4 times about the (rot, tilt) axis."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    a = np.asarray(euler_matrix(rot, tilt, 0.0), np.float64)[2]
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    v = np.zeros((n, n, n), np.float32)
    for p, s in (((6.0, 1.0, 2.0), 2.0), ((3.0, -5.0, -3.0), 1.6),
                 ((-2.0, 7.0, 4.0), 1.8)):
        for k in range(4):
            th = np.pi / 2 * k
            R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
            c = R @ np.array(p)
            v += np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2
                          + (z - c[2]) ** 2) / (2 * s * s))
    return v


@pytest.mark.parametrize("extra", [["--rot", "0", "350", "10", "--tilt",
                                    "0", "90", "10"],
                                   ["--localRot", "28", "52", "--mask",
                                    "circular", "12"],
                                   ["--rot", "20", "40", "10", "--tilt", "40",
                                    "60", "10", "--useSplines"]])
def test_volume_find_symmetry_rot_matches_the_reference(data, extra):
    d = data
    save_image(str(d / "c4.vol"), _c4_volume(24, 30.0, 50.0))
    pj, pt = both("volume_find_symmetry", lambda t: [
        "-i", str(d / "c4.vol"), "-o", str(d / t / "sym.xmd"), "--sym",
        "rot", "4", *extra])
    if "--localRot" in extra:
        assert abs(pt.best_rot - pj.best_rot) <= 0.05
        assert abs(pt.best_tilt - pj.best_tilt) <= 0.05
    else:
        assert (pt.best_rot, pt.best_tilt) == (pj.best_rot, pj.best_tilt)
        assert (pt.best_rot, pt.best_tilt) == (30.0, 50.0)
    assert abs(pt.best_corr - pj.best_corr) <= 1e-4


def _helix(n, rise, twist):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    v = np.zeros((n, n, n), np.float32)
    for k in range(-12, 13):
        a = np.deg2rad(twist * k)
        v += np.exp(-((x - 6 * np.cos(a)) ** 2 + (y - 6 * np.sin(a)) ** 2
                      + (z - rise * k) ** 2) / (2 * 1.5 ** 2))
    return v


@pytest.mark.parametrize("extra", [["-z", "4", "8", "1", "--rotHelical",
                                    "-60", "60", "10", "--sampling", "2"],
                                   ["--localHelical", "6.2", "-38",
                                    "--sampling", "2", "--sym2", "C1"]])
def test_volume_find_symmetry_helical_matches_the_reference(data, extra):
    d = data
    save_image(str(d / "helix.vol"), _helix(24, 3.0, 40.0))
    pj, pt = both("volume_find_symmetry", lambda t: [
        "-i", str(d / "helix.vol"), "-o", str(d / t / "hel.xmd"), "--sym",
        "helical", *extra])
    if "--localHelical" in extra:
        assert abs(pt.best_z - pj.best_z) <= 0.05
        assert abs(pt.best_rot - pj.best_rot) <= 0.05
    else:
        assert (pt.best_z, pt.best_rot) == (pj.best_z, pj.best_rot)
        assert rel(vol(d / "t" / "hel.xmp"), vol(d / "j" / "hel.xmp")) \
            <= 1e-4


def test_run_farms_the_commands_and_fails_on_a_failure(data, tmp_path,
                                                       capsys):
    ok = tmp_path / "ok.txt"
    ok.write_text("".join(f"{sys.executable} -c \"open(r'{tmp_path}/"
                          f"o{i}_$TAG', 'w')\"\n" for i in range(4))
                  + "# a comment\n")
    for tag, get in (("j", jax_program), ("t", get_program)):
        os.environ["TAG"] = tag
        assert get("run").run_with_args(["-i", str(ok), "-j", "2", "-v",
                                         "0"]) == 0
        assert all((tmp_path / f"o{i}_{tag}").exists() for i in range(4))
    bad = tmp_path / "bad.txt"
    bad.write_text("true\nexit 3\ntrue\n")
    for get in (jax_program, get_program):
        prog = get("run")
        assert prog.run_with_args(["-i", str(bad), "-j", "2", "-v", "0"]) \
            == 1
        assert prog.n_failed == 1
    assert "1/3 commands failed" in capsys.readouterr().err


def test_denoising_tv_matches_the_reference(data):
    d = data
    both("denoising_tv", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / "tv.mrcs"),
        "--weight", "0.2", "--iter", "30"])
    assert rel(vol(d / "t" / "tv.mrcs"), vol(d / "j" / "tv.mrcs")) <= 1e-5


# -- grammar, aliases, refused flags ----------------------------------------

@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_the_registry_holds_140_endpoints():
    from xmipp3_tpu_torch.programs import list_programs
    import test_torch_cli_flex as flex
    import test_torch_cli_flex_tail as flex_tail
    import test_torch_cli_micrograph as micrograph
    import test_torch_cli_misc as misc
    import test_torch_cli_tail as tail
    import test_torch_cli_tomo as tomo
    import test_torch_cli_volume as volume
    names = set(list_programs())
    assert set(NEW) | set(NEW_ALIASES) <= names
    # the endpoints of later slices (tests/test_torch_cli_micrograph.py,
    # tests/test_torch_cli_misc.py, tests/test_torch_cli_volume.py,
    # tests/test_torch_cli_flex.py, tests/test_torch_cli_flex_tail.py,
    # tests/test_torch_cli_tomo.py, tests/test_torch_cli_tail.py) aside
    later = set().union(*(set(m.NEW) | set(m.NEW_ALIASES)
                          for m in (micrograph, misc, volume, flex,
                                    flex_tail, tomo, tail)))
    assert len(names - later) == 140 and len(set(ALIASES) - later) == 43


REFUSED = {
    "volume_find_symmetry": (["-i", "V", "--sym", "rot", "4", "--thr", "8"],
                             "--thr"),
    "classify_first_split3": (["-i", "P", "--oroot", "O", "--mask",
                               "m.vol"], "--mask"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_flags_the_reference_never_reads_are_refused(data, tmp_path, name,
                                                      capsys):
    d = data
    args, flag = REFUSED[name]
    sub = {"P": str(d / "views.xmd"), "V": str(d / "vol.vol"),
           "O": str(tmp_path / "out")}
    assert get_program(name).run_with_args(
        [sub.get(a, a) for a in args] + ["--device", "cpu", "-v", "0"]) == 1
    err = capsys.readouterr().err
    assert flag in err and "never reads" in err
    assert not list(tmp_path.iterdir())
