"""The programs of the angular-assignment, subtraction, residual, SSNR and
common-lines slice (phantom programs: tests/test_torch_phantom.py) against
the reference package's on the same files, on the CPU (N=32, the 8-blob
phantom, 24 views 3-5 degrees and 1-1.5 px off their true poses, with noise
and per-row CTFs), the port with --device cpu; the reference's 10 aliases
of them and its grammar; and the flags the reference declares and never
reads, which the port refuses.

Tolerances, relative to the max of the reference's output where not said:
- angular_continuous_assign2 / angular_continuous_assign /
  continuous_create_residuals: angles 2e-3 degrees, shifts 2e-4 px, cost
  and maxCC 1e-4, gray, scale and defocus 1e-4 relative; residual and
  projection stacks 1e-4 (the same Adam steps through the same projector;
  the port sums the per-particle losses where the reference scales the
  mean, tests/test_torch_continuous.py);
- angular_class_average: the averages and halves 1e-5 (the same
  registration; mean orders differ), counts and rows equal;
- subtract_projection: the subtracted stack 1e-4 (2e-3 with --boost,
  which divides by the fitted transfer and so amplifies roundoff where it
  is small) and its R2 / beta / b columns 1e-4 of their max (CTF in
  float32 on both sides);
- image_residuals: covariances 1e-5, z-scores 1e-4, divergences 1e-4
  (after subtract_projection the residual means are roundoff, so their
  z-scores are not compared: the means are held below 1e-6 of the
  residuals' std in both);
- angular_discrete_assign, angular_assignment_mag: the same reference and
  flip for >= 90 % of the views (low-band and ring correlations near ties
  roundoff can flip), psi within 0.5 degrees and shifts 0.05 px on those;
- multireference_aligneability (the simple engine's K4 plain version): the
  accuracy weights 1e-4, precision 1e-3; its reference engine and
  validation_nontilt, angular_break_symmetry, angular_neighbourhood,
  angular_estimate_tilt_axis: equal (host numpy in both);
- compare_views: 5e-5 (correlations of float32 projections);
  resolution_ssnr: the table's ratios 1e-4 relative, its dB columns 1e-3
  dB; the VSSNR, a ratio of power ratios, 1e-4 of its max on all but 0.1 %
  of the voxels (read: 6-8 of 32,768 voxels above 1e-4), and every voxel
  within 64 float32 roundings, scaled by its conditioning, of the same
  VSSNR in float64 (read: at most 0.38 of that bound; the reference 0.08);
- angular_commonline: --tryInitial's energy 1e-5; the search the same
  angles for >= 6 of the 8 images (argmax over a candidate grid), the
  energy 1e-3.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.errors import XmippError
from xmipp3_tpu_torch.ops.ctf import CTFDescription
from xmipp3_tpu_torch.ops.project import FourierProjector
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

N, B = 32, 24
NEW = ["phantom_create", "phantom_project", "project",
       "phantom_simulate_microscope", "angular_continuous_assign2",
       "angular_continuous_assign", "angular_class_average",
       "angular_neighbourhood", "subtract_projection", "image_residuals",
       "angular_discrete_assign", "angular_assignment_mag",
       "angular_break_symmetry", "angular_estimate_tilt_axis",
       "multireference_aligneability", "validation_nontilt",
       "compare_views", "resolution_ssnr", "continuous_create_residuals",
       "angular_commonline"]
NEW_ALIASES = ["mpi_angular_assignment_mag", "mpi_angular_class_average",
               "mpi_angular_continuous_assign",
               "mpi_angular_continuous_assign2",
               "mpi_angular_discrete_assign",
               "mpi_continuous_create_residuals",
               "mpi_multireference_aligneability",
               "mpi_subtract_projection", "mpi_validation_nontilt",
               "cuda_angular_continuous_assign2"]
# programs whose --mesh defaults to auto: both packages run their serial
# path here (--mesh none; tests/test_torch_parallel.py holds the port's
# mesh runs)
MESHED = ("angular_class_average", "angular_discrete_assign",
          "angular_assignment_mag")


def both(name, args_of, device=True):
    """Run `name` through both dispatchers; args_of(tag) gives each run's
    arguments ("j" for the reference, "t" for the port). Returns the two
    program objects and their standard output."""
    progs, outs = [], []
    for tag, get in (("j", jax_program), ("t", get_program)):
        prog = get(name)
        tail = ["-v", "0"] + (["--mesh", "none"] if name in MESHED else []) \
            + (["--device", "cpu"] if tag == "t" and device else [])
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert prog.run_with_args(args_of(tag) + tail) == 0, tag
        progs.append(prog)
        outs.append(buf.getvalue())
    return progs, outs


def stack(path):
    return np.asarray(Image(str(path)).data, np.float64)


def rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def rows(path, block=None):
    md = MetaData(str(path), block=block)
    return [md.getRow(i) for i in md]


def col(rs, k):
    return np.array([float(r[k]) for r in rs])


def angdiff(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


def _ctf_row(i):
    c = CTFDescription(sampling_rate=2.0, voltage=300, Cs=2.7, Q0=0.1,
                       defocusU=11000 + 300 * i, defocusV=11500 + 300 * i,
                       azimuthal_angle=15.0 * i)
    return {lbl: float(getattr(c, a)) for a, lbl in
            CTFDescription._MD_MAP.items()}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The phantom, a second volume, the reference's 15-degree gallery of
    the phantom, 24 noisy shifted views with poses near their true ones
    (with CTF labels, flips and a class assignment), and masks."""
    d = tmp_path_factory.mktemp("angular")
    for t in "jt":
        (d / t).mkdir()
    vol = phantom8(N)
    save_image(str(d / "vol.vol"), vol)
    save_image(str(d / "vol2.vol"), phantom8(N, scale=N / 44))
    assert jax_program("angular_project_library").run_with_args(
        ["-i", str(d / "vol.vol"), "-o", str(d / "gal"), "--sampling_rate",
         "15", "-v", "0"]) == 0
    gal = rows(d / "gal.doc")
    rng = np.random.default_rng(21)
    ref = rng.integers(0, len(gal), B)
    rot = col(gal, "angleRot")[ref].astype(np.float32)
    tilt = col(gal, "angleTilt")[ref].astype(np.float32)
    psi = rng.uniform(-180, 180, B).astype(np.float32)
    sx, sy = rng.uniform(-2, 2, (2, B)).astype(np.float32)
    imgs = FourierProjector(vol, device="cpu").project_euler(
        rot, tilt, psi, shifts=np.stack([-sx, -sy], 1)).numpy()
    sig = imgs.std()
    imgs += 0.1 * sig * rng.standard_normal(imgs.shape).astype(np.float32)
    save_image(str(d / "parts.mrcs"), imgs)
    off = lambda s: rng.uniform(-s, s, B)
    MetaData.fromRows(
        dict({"image": f"{i + 1:06d}@{d / 'parts.mrcs'}", "itemId": i + 1,
              "angleRot": float(rot[i] + off(4)[i]),
              "angleTilt": float(tilt[i] + off(3)[i]),
              "anglePsi": float(psi[i] + off(5)[i]),
              "shiftX": float(sx[i] + off(1)[i]),
              "shiftY": float(sy[i] + off(1)[i]), "ref": int(ref[i] + 1),
              "flip": 0, "maxCC": float(rng.uniform(0.2, 0.9))},
             **_ctf_row(i)) for i in range(B)).write(str(d / "parts.xmd"))
    # the exact poses, half of them mirrored, for the class averages and
    # the subtraction
    flip = rng.uniform(size=B) < 0.4
    MetaData.fromRows(
        dict({"image": f"{i + 1:06d}@{d / 'parts.mrcs'}", "itemId": i + 1,
              "angleRot": float(rot[i]), "angleTilt": float(tilt[i]),
              "anglePsi": float(psi[i]), "shiftX": float(sx[i]),
              "shiftY": float(sy[i]), "ref": int(ref[i] % 5 + 1),
              "flip": int(flip[i]), "maxCC": float(rng.uniform(0.2, 0.9))},
             **_ctf_row(i)) for i in range(B)).write(str(d / "exact.xmd"))
    z, y, x = np.mgrid[0:N, 0:N, 0:N] - N // 2
    save_image(str(d / "roi.vol"), (((z - 3) ** 2 + (y + 2) ** 2 + x ** 2)
                                    < 36).astype(np.float32))
    save_image(str(d / "mask.vol"), ((z ** 2 + y ** 2 + x ** 2) < 169)
               .astype(np.float32))
    return d


# -- continuous assignment ---------------------------------------------------

def _hold_refined(got, want, extra=()):
    assert len(got) == len(want)
    for k in ("angleRot", "angleTilt", "anglePsi"):
        assert angdiff(col(got, k), col(want, k)).max() <= 2e-3, k
    for k in ("shiftX", "shiftY"):
        assert np.abs(col(got, k) - col(want, k)).max() <= 2e-4, k
    for k in ("cost", "maxCC"):
        assert np.abs(col(got, k) - col(want, k)).max() <= 1e-4, k
    for k in extra:
        assert rel(col(got, k), col(want, k)) <= 1e-4, k
    assert [r["itemId"] for r in got] == [r["itemId"] for r in want]


ASSIGN2 = {
    "pose": (["--optimizeAngles", "--optimizeShift", "--steps", "10"], ()),
    "full": (["--optimizeAngles", "--optimizeShift", "--optimizeGray",
              "--Rmax", "13", "--sampling", "2", "--max_resolution", "5",
              "--steps", "6", "--oresiduals", "RES", "--oprojections",
              "PROJ"], ("continuousA", "ctfDefocusU")),
    "defocus_scale": (["--optimizeAngles", "--optimizeDefocus",
                       "--sameDefocus", "--phaseFlipped", "--optimizeScale",
                       "--sampling", "2", "--max_shift", "1", "--steps",
                       "5"], ("scale", "ctfDefocusU", "ctfDefocusV")),
    "apply_to": (["--optimizeShift", "--ignoreCTF", "--optimizeGray",
                  "--steps", "4", "--applyTo", "image"],
                 ("continuousA",)),
}


@pytest.mark.parametrize("case", list(ASSIGN2))
def test_angular_continuous_assign2_matches_the_reference(data, case):
    d = data
    args, extra = ASSIGN2[case]
    sub = lambda t: [str(d / t / f"{case}_{a.lower()}.stk")
                     if a in ("RES", "PROJ") else a for a in args]
    both("angular_continuous_assign2", lambda t: [
        "-i", str(d / "parts.xmd"), "-o", str(d / t / f"a2_{case}.xmd"),
        "--ref", str(d / "vol.vol"), *sub(t)])
    got, want = rows(d / "t" / f"a2_{case}.xmd"), \
        rows(d / "j" / f"a2_{case}.xmd")
    _hold_refined(got, want, extra)
    for a in ("res", "proj"):
        fn = f"{case}_{a}.stk"
        if (d / "j" / fn).exists():
            assert rel(stack(d / "t" / fn), stack(d / "j" / fn)) <= 1e-4
    if case == "apply_to":
        assert rel(stack(d / "t" / f"a2_{case}_aligned.stk"),
                   stack(d / "j" / f"a2_{case}_aligned.stk")) <= 1e-4


def test_angular_continuous_assign_matches_the_reference(data):
    d = data
    both("angular_continuous_assign", lambda t: [
        "-i", str(d / "parts.xmd"), "-o", str(d / t / "a1.xmd"), "--ref",
        str(d / "vol.vol"), "--optimizeShift", "--steps", "8",
        "--max_angular_change", "4", "--max_shift", "2",
        "--gaussian_Fourier", "0.4", "--zerofreq_weight", "0.5"])
    _hold_refined(rows(d / "t" / "a1.xmd"), rows(d / "j" / "a1.xmd"))


def test_continuous_create_residuals_matches_the_reference(data):
    d = data
    both("continuous_create_residuals", lambda t: [
        "-i", str(d / "parts.xmd"), "-o", str(d / t / "ccr.xmd"), "--ref",
        str(d / "vol.vol"), "--optimizeShift", "--optimizeAngles", "--steps",
        "5", "--oresiduals", str(d / t / "ccr.stk")])
    got, want = rows(d / "t" / "ccr.xmd"), rows(d / "j" / "ccr.xmd")
    _hold_refined(got, want)
    assert [r["imageResidual"].replace("/t/", "/j/") for r in got] == \
        [r["imageResidual"] for r in want]
    assert rel(stack(d / "t" / "ccr.stk"), stack(d / "j" / "ccr.stk")) \
        <= 1e-4


# -- class averages and neighbourhoods ---------------------------------------

CLASS_AVG = {
    "split_limits": ["--split", "--limitRclass", "20", "--limitRper", "10",
                     "--siatc"],
    "pca": ["--pcaSorting", "--select", "maxCC", "--limit0", "0.25"],
    "iter": ["--iter", "1", "--Ri", "2", "--Ro", "13"],
    "wien": ["--wien", "WIEN", "--pad", "2"],
}


@pytest.mark.parametrize("case", list(CLASS_AVG))
def test_angular_class_average_matches_the_reference(data, case):
    d = data
    if case == "wien":
        fy = np.fft.fftfreq(2 * N)[:, None]
        fx = np.fft.rfftfreq(2 * N)[None, :]
        save_image(str(d / "wien.xmp"), np.exp(-(fx ** 2 + fy ** 2) / 0.05)
                   .astype(np.float32))
    args = [str(d / "wien.xmp") if a == "WIEN" else a
            for a in CLASS_AVG[case]]
    both("angular_class_average", lambda t: [
        "-i", str(d / "exact.xmd"), "--lib", str(d / "gal.doc"), "-o",
        str(d / t / f"ca_{case}"), *args])
    tol = 1e-4 if case == "iter" else 1e-5
    assert rel(stack(d / "t" / f"ca_{case}.stk"),
               stack(d / "j" / f"ca_{case}.stk")) <= tol
    got, want = rows(d / "t" / f"ca_{case}.xmd"), \
        rows(d / "j" / f"ca_{case}.xmd")
    assert [(r["ref"], r["classCount"]) for r in got] == \
        [(r["ref"], r["classCount"]) for r in want]
    if case == "split_limits":
        for h in (1, 2):
            fn = f"ca_{case}_split{h}.stk"
            assert rel(stack(d / "t" / fn), stack(d / "j" / fn)) <= 1e-5
        blocks = [f"class{k:06d}_images" for k in range(1, 6)]
        for b in blocks:
            assert [r["itemId"] for r in rows(d / "t" / f"ca_{case}_images"
                                              ".xmd", b)] == \
                [r["itemId"] for r in rows(d / "j" / f"ca_{case}_images.xmd",
                                           b)]


def test_angular_neighbourhood_matches_the_reference(data):
    d = data
    both("angular_neighbourhood", lambda t: [
        "--i1", str(d / "parts.xmd"), "--i2", str(d / "gal.doc"), "-o",
        str(d / t / "nb.xmd"), "--dist", "20", "--sym", "c2",
        "--check_mirrors"])
    got, want = rows(d / "t" / "nb.xmd"), rows(d / "j" / "nb.xmd")
    assert [(r["ref"], r["count"], list(r["neighbors"])) for r in got] == \
        [(r["ref"], r["count"], list(r["neighbors"])) for r in want]


# -- subtraction and residuals -------------------------------------------------

SUBTRACT = {
    "plain": [],
    "roi_subtract": ["--mask_roi", "ROI", "--subtract", "--nonNegative",
                     "--save", "SAVE", "--max_resolution", "4",
                     "--sampling", "2"],
    "boost": ["--mask_roi", "ROI", "--boost", "--cirmaskrad", "12"],
    "real_space": ["--realSpaceProjection", "--ignoreCTF"],
    "mask_noise": ["--mask", "MASK", "--noise_est", "--padding", "1.5"],
}


@pytest.mark.parametrize("case", list(SUBTRACT))
def test_subtract_projection_matches_the_reference(data, case):
    d = data
    (d / "j" / case).mkdir(exist_ok=True)
    (d / "t" / case).mkdir(exist_ok=True)
    sub = {"ROI": str(d / "roi.vol"), "MASK": str(d / "mask.vol")}
    both("subtract_projection", lambda t: [
        "-i", str(d / "exact.xmd"), "--ref", str(d / "vol.vol"), "-o",
        str(d / t / case / "sub"),
        *[str(d / t / case / "adj.mrcs") if a == "SAVE" else sub.get(a, a)
          for a in SUBTRACT[case]]])
    tj, tt = d / "j" / case, d / "t" / case
    # --boost divides by the fitted transfer, which amplifies roundoff
    # where it is small
    assert rel(stack(tt / "sub.mrcs"), stack(tj / "sub.mrcs")) <= \
        (2e-3 if case == "boost" else 1e-4)
    got, want = rows(tt / "sub.xmd"), rows(tj / "sub.xmd")
    for k in ("subtractionR2", "subtractionBeta0", "subtractionBeta1",
              "subtractionB"):
        scale = max(np.abs(col(want, k)).max(), 1e-6)
        assert np.abs(col(got, k) - col(want, k)).max() <= 1e-4 * scale, k
    assert [r.get("enabled", 1) for r in got] == \
        [r.get("enabled", 1) for r in want]
    if case == "roi_subtract":
        assert rel(stack(tt / "adj.mrcs"), stack(tj / "adj.mrcs")) <= 1e-4
    if case == "mask_noise":
        assert rel(stack(tt / "noisePower.mrc"),
                   stack(tj / "noisePower.mrc")) <= 1e-4


@pytest.mark.parametrize("case", ["stack", "ref_normalized"])
def test_image_residuals_matches_the_reference(data, case):
    d = data
    if case == "stack":
        args = lambda t: ["-i", str(d / "parts.mrcs"), "-o",
                          str(d / t / "ir_stack")]
    else:
        args = lambda t: ["-i", str(d / "exact.xmd"), "--ref",
                          str(d / "vol.vol"), "-o", str(d / t / "ir_ref"),
                          "--normalizeDivergence"]
    both("image_residuals", args)
    root = "ir_stack" if case == "stack" else "ir_ref"
    assert rel(stack(d / "t" / f"{root}.stk"),
               stack(d / "j" / f"{root}.stk")) <= 1e-5
    got, want = rows(d / "t" / f"{root}.xmd"), rows(d / "j" / f"{root}.xmd")
    keys = ["zScoreResVar", "zScoreResCov"]
    if case == "stack":
        keys.append("zScoreResMean")
    else:
        # the subtraction removes each image's background level, so the
        # residuals' means are roundoff (1e-8) and so are their z-scores
        for t in "jt":
            res = stack(d / t / f"{root}.mrcs")
            assert np.abs(res.mean(axis=(1, 2))).max() <= 1e-6 * res.std()
    for k in keys:
        assert rel(col(got, k), col(want, k)) <= 1e-4, k


# -- discrete assignment ------------------------------------------------------

def _hold_assignment(got, want):
    assert len(got) == len(want)
    same = [(g["ref"], g["flip"]) == (w["ref"], w["flip"])
            for g, w in zip(got, want)]
    assert np.mean(same) >= 0.9
    g = [r for r, s in zip(got, same) if s]
    w = [r for r, s in zip(want, same) if s]
    assert angdiff(col(g, "anglePsi"), col(w, "anglePsi")).max() <= 0.5
    for k in ("shiftX", "shiftY"):
        assert np.abs(col(g, k) - col(w, k)).max() <= 0.05, k


@pytest.mark.parametrize("extra", [[], ["--pick", "0", "--keep", "60",
                                        "--psi_step", "10",
                                        "--dont_check_mirrors"]])
def test_angular_discrete_assign_matches_the_reference(data, extra):
    d = data
    tag = "pick0" if extra else "pick1"
    both("angular_discrete_assign", lambda t: [
        "-i", str(d / "parts.xmd"), "-o", str(d / t / f"da_{tag}.xmd"),
        "--ref", str(d / "gal.doc"), "--max_shift", "4", *extra])
    _hold_assignment(rows(d / "t" / f"da_{tag}.xmd"),
                     rows(d / "j" / f"da_{tag}.xmd"))


def test_angular_assignment_mag_with_a_reference_volume(data):
    d = data
    both("angular_assignment_mag", lambda t: [
        "-i", str(d / "parts.xmd"), "-o", str(d / t / "mag.xmd"),
        "--refVol", str(d / "vol.vol"), "-angleStep", "15", "-odir",
        str(d / t / "magdir"), "--maxShift", "4"])
    _hold_assignment(rows(d / "t" / "mag.xmd"), rows(d / "j" / "mag.xmd"))


# -- orientation statistics ----------------------------------------------------

def test_angular_break_symmetry_matches_the_reference(data):
    d = data
    both("angular_break_symmetry", lambda t: [
        "-i", str(d / "parts.xmd"), "-o", str(d / t / "bs.xmd"), "--sym",
        "c4", "--seed", "3"], device=False)
    got, want = rows(d / "t" / "bs.xmd"), rows(d / "j" / "bs.xmd")
    for k in ("angleRot", "angleTilt", "anglePsi"):
        np.testing.assert_allclose(col(got, k), col(want, k), rtol=0,
                                   atol=1e-9)


def test_angular_estimate_tilt_axis_matches_the_reference(data, tmp_path):
    rng = np.random.default_rng(8)
    u = rng.uniform(0, 500, (30, 2))
    ang, tilt = np.deg2rad(35.0), np.deg2rad(40.0)
    R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    t = (R @ np.diag([1.0, np.cos(tilt)]) @ R.T @ u.T).T + [3.0, -2.0]
    for name, c in (("u", u), ("t", t)):
        MetaData.fromRows({"xcoor": float(a), "ycoor": float(b)}
                          for a, b in c).write(str(tmp_path / f"{name}.xmd"))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    (pj, pt), (oj, ot) = both("angular_estimate_tilt_axis", lambda s: [
        "--untilted", str(tmp_path / "u.xmd"), "--tilted",
        str(tmp_path / "t.xmd"), "-o", str(tmp_path / s / "axis.xmd")],
        device=False)
    assert (pt.tilt_axis_angle, pt.tilt_angle) == \
        (pj.tilt_axis_angle, pj.tilt_angle)
    assert rows(tmp_path / "t" / "axis.xmd") == \
        rows(tmp_path / "j" / "axis.xmd")
    assert abs(pt.tilt_angle - 40.0) < 0.1


def test_multireference_aligneability_simple_engine(data):
    d = data
    (pj, pt), _ = both("multireference_aligneability", lambda t: [
        "-i", str(d / "parts.xmd"), "--volume", str(d / "vol.vol"),
        "--sampling", "20", "-o", str(d / t / "mra.xmd")])
    got, want = rows(d / "t" / "mra.xmd"), rows(d / "j" / "mra.xmd")
    assert np.abs(col(got, "weightAlignabilityAccuracy")
                  - col(want, "weightAlignabilityAccuracy")).max() <= 1e-4
    assert np.abs(col(got, "weightAlignabilityPrecision")
                  - col(want, "weightAlignabilityPrecision")).max() <= 1e-3


def test_gallery_correlations_in_chunks_equal_one_call(data):
    from xmipp3_tpu_torch.programs.angular_misc import gallery_correlations
    refs = torch.as_tensor(np.squeeze(Image(str(data / "gal.stk")).data))
    imgs = np.squeeze(Image(str(data / "parts.mrcs")).data)
    one = gallery_correlations(refs, imgs, chunk=len(imgs))
    np.testing.assert_array_equal(gallery_correlations(refs, imgs, chunk=5),
                                  one)
    assert one.shape == (B, len(refs))


@pytest.fixture(scope="module")
def clouds(data):
    """Significant-style orientation clouds: 3-6 orientations an image
    (imageIndex), for the experimental images and the reference
    projections, near each image's pose."""
    d = data
    rng = np.random.default_rng(12)
    parts = rows(d / "parts.xmd")
    exp, ref = [], []
    for i, p in enumerate(parts):
        for out, spread in ((exp, 8.0), (ref, 4.0)):
            for _ in range(rng.integers(3, 7)):
                out.append({"image": p["image"], "imageIndex": i,
                            "angleRot": float(p["angleRot"]
                                              + rng.normal(0, spread)),
                            "angleTilt": float(p["angleTilt"]
                                               + rng.normal(0, spread)),
                            "anglePsi": float(p["anglePsi"]),
                            "flip": int(rng.uniform() < 0.2),
                            "maxCC": float(rng.uniform(0.3, 1.0))})
    MetaData.fromRows(exp).write(str(d / "clouds_exp.xmd"))
    MetaData.fromRows(ref).write(str(d / "clouds_ref.xmd"))
    return d


def test_multireference_aligneability_reference_engine(clouds):
    d = clouds
    for t in "jt":
        (d / t / "mra_dir").mkdir(exist_ok=True)
    both("multireference_aligneability", lambda t: [
        "-i", str(d / "parts.xmd"), "--volume", str(d / "vol.vol"),
        "--angles_file", str(d / "clouds_exp.xmd"), "--angles_file_ref",
        str(d / "clouds_ref.xmd"), "--gallery", str(d / "gal.doc"),
        "--odir", str(d / t / "mra_dir"), "--sym", "c2",
        "--check_mirrors"], device=False)
    for fn in ("pruned_particles_alignability.xmd",
               "validationAlignability.xmd"):
        got, want = rows(d / "t" / "mra_dir" / fn), \
            rows(d / "j" / "mra_dir" / fn)
        assert [{k: v for k, v in r.items() if k != "image"} for r in got] \
            == [{k: v for k, v in r.items() if k != "image"} for r in want]


def test_validation_nontilt_matches_the_reference(clouds):
    d = clouds
    for t in "jt":
        (d / t / "vnt").mkdir(exist_ok=True)
    (pj, pt), _ = both("validation_nontilt", lambda t: [
        "--i", str(d / "clouds_exp.xmd"), "--volume", str(d / "vol.vol"),
        "--gallery", str(d / "gal.doc"), "--odir", str(d / t / "vnt"),
        "--useSignificant", "--significance_noise", "0.9"], device=False)
    for fn in ("clusteringTendency.xmd", "validation.xmd"):
        got, want = rows(d / "t" / "vnt" / fn), rows(d / "j" / "vnt" / fn)
        assert [{k: v for k, v in r.items() if k != "image"} for r in got] \
            == [{k: v for k, v in r.items() if k != "image"} for r in want]
    assert pt.score == pj.score


def test_compare_views_matches_the_reference(data):
    d = data
    (pj, pt), _ = both("compare_views", lambda t: [
        "-v1", str(d / "vol.vol"), "-v2", str(d / "vol2.vol"), "-o",
        str(d / t / "cv.xmp"), "--degstep", "30"])
    assert rel(stack(d / "t" / "cv.xmp"), stack(d / "j" / "cv.xmp")) <= 5e-5


# -- SSNR ---------------------------------------------------------------------

def _table(path):
    return np.loadtxt(str(path), comments=";")


# The VSSNR is 10 log10 of a ratio of power ratios; where one of a view's
# four |FFT|^2 planes is small at a frequency, the quotient amplifies the
# float32 roundoff of either package's FFTs (the two packages read
# 5.128e-3 of the max apart on one voxel on one host, 2.6e-3 on another).
# So each voxel of the port's VSSNR is held to the same VSSNR computed in
# float64 (_vssnr_f64), within VSSNR_ROUNDINGS * u * cond + 1e-4 of the
# max: u = 2^-24; cond the voxel's dB change per unit relative error of a
# plane's |FFT| coefficients, (20 / ln 10) * the sum over the four powers
# of sqrt(mean power / power), the RMS roundoff of an FFT being spread
# over the plane; VSSNR_ROUNDINGS = 64 bounds the roundings of u along
# one coefficient's chain (the padded 64^3 cube's FFT, 18 butterfly
# stages; the 8-tap gather; irfft2 and fft2, 10 stages each; the
# residual and the quotient). The port read at most 25 u * cond; the 1e-4
# floor is what the share check allows a well-conditioned voxel.
VSSNR_ROUNDINGS = 64


def _zyz64(rot, tilt, psi):
    """ZYZ Euler matrices (B, 3, 3) in float64 (core.geometry's formula)."""
    a, b, g = (np.deg2rad(np.asarray(x, np.float64)) for x in (rot, tilt, psi))
    c1, s1, c2, s2, c3, s3 = (np.cos(a), np.sin(a), np.cos(b), np.sin(b),
                              np.cos(g), np.sin(g))
    return np.stack([
        np.stack([c3 * c2 * c1 - s3 * s1, c3 * c2 * s1 + s3 * c1, -c3 * s2], -1),
        np.stack([-s3 * c2 * c1 - c3 * s1, -s3 * c2 * s1 + c3 * c1, s3 * s2],
                 -1),
        np.stack([s2 * c1, s2 * s1, c2], -1)], axis=-2)


def _project64(vol, mats):
    """Fourier central-slice projections in float64: the volume padded
    twice, its centred FFT, a trilinear gather of each slice, irfft2."""
    n = vol.shape[-1]
    lo = n // 2 + n % 2
    vf = np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(np.pad(
        vol.astype(np.float64), [(lo, n - lo)] * 3))))
    P, c = 2 * n, n
    kx = (np.fft.rfftfreq(n) * P)[None, None, :]
    ky = (np.fft.fftfreq(n) * P)[None, :, None]
    M = mats[:, :, :, None, None]
    pos = [kx * M[:, 0, a] + ky * M[:, 1, a] + c for a in (2, 1, 0)]
    p0 = [np.floor(p).astype(np.int64) for p in pos]
    fr = [p - q for p, q in zip(pos, p0)]
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                q = [p0[0] + dz, p0[1] + dy, p0[2] + dx]
                w = np.ones_like(fr[0])
                for f, dd in zip(fr, (dz, dy, dx)):
                    w = w * (f if dd else 1 - f)
                ok = np.all([(a >= 0) & (a < P) for a in q], axis=0)
                q = [np.clip(a, 0, P - 1) for a in q]
                out = out + np.where(ok, w, 0.0) * vf[q[0], q[1], q[2]]
    return np.fft.fftshift(np.fft.irfft2(out, s=(n, n)), axes=(-2, -1))


def _vssnr_f64(fn_signal, fn_noise, fn_sel_s, fn_sel_n, min_power=1e-10):
    """The VSSNR of resolution_ssnr --gen_VSSNR in float64 numpy: per view
    10 log10(max(issnr / alpha - 1, 0) + 1) of the four |FFT|^2 planes,
    trilinearly scattered into the centred 3-D grid and averaged."""
    vS = np.squeeze(Image(str(fn_signal)).data)
    vN = np.squeeze(Image(str(fn_noise)).data)
    rs, rn = rows(fn_sel_s), rows(fn_sel_n)
    ang = [np.array([float(r.get(k, 0.0)) for r in rs], np.float32)
           for k in ("angleRot", "angleTilt", "anglePsi")]
    mats = _zyz64(*ang)
    load = lambda rr: np.stack([np.squeeze(Image(r["image"]).data)
                                for r in rr]).astype(np.float64)
    pS, pN = _project64(vS, mats), _project64(vN, mats)
    pw = lambda x: np.abs(np.fft.fft2(x)) ** 2
    S2s, N2s = pw(pS), pw(load(rs) - pS)
    S2n, N2n = pw(pN), pw(load(rn) - pN)
    issnr = np.where(N2s > min_power, S2s / np.maximum(N2s, 1e-300), 0.0)
    alpha = np.where(N2n > min_power, S2n / np.maximum(N2n, 1e-300), 0.0)
    ssnr = np.where(alpha > min_power, np.maximum(
        issnr / np.maximum(alpha, 1e-30) - 1.0, 0.0), 0.0)
    maps = 10.0 * np.log10(ssnr + 1.0)
    # dB per unit relative error of a plane's |FFT| (u = 1): 20/ln 10 times
    # the sum over the four powers of sqrt(mean power / power)
    cond = (20.0 / np.log(10.0)) * sum(
        np.sqrt(m / np.maximum(x, 1e-30 * m))
        for x in (S2s, N2s, S2n, N2n)
        for m in [x.mean(axis=(1, 2), keepdims=True)])
    B, n, _ = maps.shape
    f = np.fft.fftfreq(n) * n
    fy, fx = np.meshgrid(f, f, indexing="ij")
    p = (fx.reshape(1, -1, 1) * mats[:, None, 0]
         + fy.reshape(1, -1, 1) * mats[:, None, 1] + n // 2).reshape(-1, 3)
    v = maps.reshape(-1)
    k = cond.reshape(-1)
    p0 = np.floor(p).astype(np.int64)
    fr = p - p0
    sums, ksum, wsum = np.zeros(n ** 3), np.zeros(n ** 3), np.zeros(n ** 3)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                q = p0 + np.array([dx, dy, dz])
                w = (np.abs(1 - dx - fr[:, 0]) * np.abs(1 - dy - fr[:, 1])
                     * np.abs(1 - dz - fr[:, 2]))
                w = np.where(((q >= 0) & (q < n)).all(axis=1), w, 0.0)
                q = np.clip(q, 0, n - 1)
                idx = (q[:, 2] * n + q[:, 1]) * n + q[:, 0]
                np.add.at(sums, idx, w * v)
                np.add.at(ksum, idx, w * k)
                np.add.at(wsum, idx, w)
    wsum = np.maximum(wsum, 1e-12)
    return (sums / wsum).reshape(n, n, n), (ksum / wsum).reshape(n, n, n)


def test_resolution_ssnr_matches_the_reference(data):
    d = data
    noise = np.random.default_rng(4).standard_normal((B, N, N)) \
        .astype(np.float32)
    save_image(str(d / "noise.mrcs"), noise)
    md = rows(d / "exact.xmd")
    MetaData.fromRows(dict(r, image=f"{i + 1:06d}@{d / 'noise.mrcs'}")
                      for i, r in enumerate(md)).write(str(d / "noise.xmd"))
    save_image(str(d / "noise.vol"), 0.01 * np.random.default_rng(5)
               .standard_normal((N, N, N)).astype(np.float32))
    both("resolution_ssnr", lambda t: [
        "--signal", str(d / "vol.vol"), "--noise", str(d / "noise.vol"),
        "--sel_signal", str(d / "exact.xmd"), "--sel_noise",
        str(d / "noise.xmd"), "-o", str(d / t / "ssnr.txt"), "--ring", "2",
        "--sampling_rate", "2", "--gen_VSSNR", "--VSSNR",
        str(d / t / "vssnr.vol")])
    got, want = _table(d / "t" / "ssnr.txt"), _table(d / "j" / "ssnr.txt")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    for c in (3, 6):
        assert np.abs(got[:, c] - want[:, c]).max() <= \
            1e-4 * np.abs(want[:, c]).max(), c
    for c in (2, 4, 5, 7, 8):
        assert np.abs(got[:, c] - want[:, c]).max() <= 1e-3, c
    # a ratio of power ratios: where a plane's noise residual power is
    # small, float32 roundoff moves a few voxels by more
    v_t, v_j = stack(d / "t" / "vssnr.vol"), stack(d / "j" / "vssnr.vol")
    err = np.abs(v_t - v_j) / np.abs(v_j).max()
    assert (err > 1e-4).mean() <= 1e-3
    # so each voxel is held to the float64 VSSNR within its conditioning
    want, cond = _vssnr_f64(d / "vol.vol", d / "noise.vol", d / "exact.xmd",
                            d / "noise.xmd")
    bound = VSSNR_ROUNDINGS * 2.0 ** -24 * cond + 1e-4 * np.abs(want).max()
    assert (np.abs(v_t - want) <= bound).all()
    both("resolution_ssnr", lambda t: [
        "--radial_avg", "--VSSNR", str(d / "j" / "vssnr.vol"), "-o",
        str(d / t / "radial.txt"), "--ring", "2"])
    np.testing.assert_allclose(_table(d / "t" / "radial.txt"),
                               _table(d / "j" / "radial.txt"), rtol=0,
                               atol=1e-9)


# -- common lines -------------------------------------------------------------

@pytest.fixture(scope="module")
def averages(data):
    d = data
    rng = np.random.default_rng(30)
    rot = rng.uniform(0, 360, 8).astype(np.float32)
    tilt = rng.uniform(20, 160, 8).astype(np.float32)
    psi = rng.uniform(0, 360, 8).astype(np.float32)
    imgs = FourierProjector(phantom8(N), device="cpu").project_euler(
        rot, tilt, psi).numpy()
    save_image(str(d / "avgs.mrcs"), imgs)
    MetaData.fromRows({"image": f"{i + 1:06d}@{d / 'avgs.mrcs'}",
                       "angleRot": float(rot[i]), "angleTilt": float(tilt[i]),
                       "anglePsi": float(psi[i])}
                      for i in range(8)).write(str(d / "avgs.xmd"))
    return d


def test_angular_commonline_try_initial(averages):
    d = averages
    both("angular_commonline", lambda t: [
        "-i", str(d / "avgs.xmd"), "--oang", str(d / t / "cl0.xmd"),
        "--tryInitial"])
    got, want = rows(d / "t" / "cl0.xmd"), rows(d / "j" / "cl0.xmd")
    assert abs(got[0]["cost"] - want[0]["cost"]) <= 1e-5


def test_angular_commonline_search(averages):
    d = averages
    both("angular_commonline", lambda t: [
        "-i", str(d / "avgs.xmd"), "--oang", str(d / t / "cl.xmd"),
        "--NGen", "1000", "--NGroup", "2"])
    got, want = rows(d / "t" / "cl.xmd"), rows(d / "j" / "cl.xmd")
    same = [all(angdiff(np.float64(g[k]), np.float64(w[k])) < 1e-3
                for k in ("angleRot", "angleTilt", "anglePsi"))
            for g, w in zip(got, want)]
    assert sum(same) >= 6
    assert abs(got[0]["cost"] - want[0]["cost"]) <= 1e-3


# -- grammar, aliases, refused flags --------------------------------------------

@pytest.mark.parametrize("alias", NEW_ALIASES + ["project"])
def test_alias_dispatches_to_its_program(alias):
    target = ALIASES.get(alias, "phantom_project")
    assert type(get_program(alias)) is type(get_program(target))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_the_registry_holds_115_endpoints():
    from xmipp3_tpu_torch.programs import list_programs
    import test_torch_cli_analysis as analysis
    import test_torch_cli_flex as flex
    import test_torch_cli_flex_tail as flex_tail
    import test_torch_cli_micrograph as micrograph
    import test_torch_cli_misc as misc
    import test_torch_cli_tail as tail
    import test_torch_cli_tomo as tomo
    import test_torch_cli_volume as volume
    names = set(list_programs())
    assert set(NEW) | set(NEW_ALIASES) <= names
    # the endpoints of later slices (tests/test_torch_cli_analysis.py,
    # tests/test_torch_cli_micrograph.py, tests/test_torch_cli_misc.py,
    # tests/test_torch_cli_volume.py, tests/test_torch_cli_flex.py,
    # tests/test_torch_cli_flex_tail.py, tests/test_torch_cli_tomo.py,
    # tests/test_torch_cli_tail.py) aside
    later = set().union(*(set(m.NEW) | set(m.NEW_ALIASES)
                          for m in (analysis, micrograph, misc, volume,
                                    flex, flex_tail, tomo, tail)))
    assert len(names - later) == 115 and len(set(ALIASES) - later) == 37


REFUSED = {
    "subtract_projection": (["-i", "P", "--ref", "V", "-o", "O", "--sigma",
                             "2"], "--sigma"),
    "multireference_aligneability": (["-i", "P", "--volume", "V", "-o", "O",
                                      "-i2", "P"], "-i2"),
    "validation_nontilt": (["--i", "P", "--odir", "D", "--check_mirrors"],
                           "--check_mirrors"),
    "angular_assignment_mag": (["-i", "P", "-o", "O", "--ref", "G",
                                "-sampling", "2"], "-sampling"),
    "angular_discrete_assign": (["-i", "P", "-o", "O", "--ref", "G",
                                 "--show_psi_shift"], "--show_psi_shift"),
    "resolution_ssnr": (["--radial_avg", "--VSSNR", "V", "--sym", "c4"],
                        "--sym"),
    "angular_commonline": (["-i", "P", "--oang", "O", "--sym", "c2"],
                           "--sym"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_flags_the_reference_never_reads_are_refused(data, tmp_path, name,
                                                      capsys):
    d = data
    args, flag = REFUSED[name]
    sub = {"P": str(d / "parts.xmd"), "V": str(d / "vol.vol"),
           "G": str(d / "gal.doc"), "O": str(tmp_path / "out.xmd"),
           "D": str(tmp_path)}
    argv = [sub.get(a, a) for a in args] + ["--device", "cpu", "-v", "0"]
    try:
        rc = get_program(name).run_with_args(argv)
    except XmippError as e:
        assert flag in str(e) and "never reads" in str(e)
        return
    assert rc == 1
    assert flag in capsys.readouterr().err
    assert not (tmp_path / "out.xmd").exists()
