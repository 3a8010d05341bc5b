"""The tomography programs (tomo_programs, tomo_misc,
tomo_landmark_residuals, align_tilt_pairs) and three programs of the long
tail that work on the same data (tomo_misalignment_resid_statistics,
image_peak_high_contrast, image_assignment_tilt_pair) against the
reference package's on the same files, on the CPU (a 48 x 48 x 16
tomogram of 4 particles of the 8-blob phantom at 16^3 and 3 gold
fiducials, its 11 tilt images at 48^2 over +-30 degrees), the port with
--device cpu; the aliases project_tomography and mpi_subtomo_subtraction;
the flags the reference declares and never reads; the non-square inputs.

Tolerances, relative to the max of the reference's output where not said:
- host programs (the residual statistics and verdicts, the coordinate
  filter's mask path, the tilt-pair assignment): equal files;
- tomo_simulate_tilt_series: the tomogram equal (host numpy, the same
  draws), the series 1e-5 (each particle's projections through the two
  packages' float32 Fourier projectors);
- tomo_project, tomo_tiltseries_dose_filter, tomo_ctf_wiener2d_correction,
  tomo_extract_subtomograms (with --downsample), tomo_average_subtomos,
  tomo_map_back, tomo_extract_particlestacks: 1e-5 (float32 FFTs, warps
  and sums in another order);
- tomogram_reconstruction: 5e-3 (the Kaiser-Bessel gridding's window: K3's
  plain version with its degree-7 polynomial against the reference's
  Bessel window, the kb tolerance of tests/test_torch_reconstruct.py);
- tomo_detect_landmarks and image_peak_high_contrast: the same
  coordinates, costs 1e-4;
- tomo_calculate_landmark_residuals: positions and residuals 1e-4 px;
- tomo_detect_missing_wedge: the same two planes (a grid search: the
  argmax of float32 scores) and masks; the marked dB magnitudes 1e-5
  where |F| is at least 1e-3 of its max (inside the missing wedge |F| is
  float32 roundoff, which 20 log10 turns into noise: 5.4e-4 there);
- tomo_filter_coordinates with --inTomo: avg and stddev 1e-9 relative
  (float64 sums in another order);
- subtomo_subtraction: 1e-4 (the POCS loop of tests/test_torch_pocs.py);
- image_align_tilt_pairs: shifts 1e-3 px, the rest equal.
"""
import io
import os
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_cli_analysis import rel, rows, vol
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

X, Z, BOX = 48, 16, 16
TILTS = ("--tiltRange", -30, 30, 6)
NEW = ["tomo_project", "project_tomography", "tomo_simulate_tilt_series",
       "tomo_extract_subtomograms", "tomo_average_subtomos",
       "tomo_tiltseries_dose_filter", "tomo_detect_missing_wedge",
       "tomogram_reconstruction", "tomo_detect_landmarks",
       "tomo_filter_coordinates", "tomo_map_back",
       "tomo_ctf_wiener2d_correction", "subtomo_subtraction",
       "tomo_calculate_landmark_residuals",
       "tomo_detect_misalignment_residuals", "tomo_extract_particlestacks",
       "image_align_tilt_pairs", "tomo_misalignment_resid_statistics",
       "image_peak_high_contrast", "image_assignment_tilt_pair"]
NEW_ALIASES = ["mpi_subtomo_subtraction"]
CTF_ROW = {"ctfVoltage": 300.0, "ctfSphericalAberration": 2.7,
           "ctfQ0": 0.07, "ctfSamplingRate": 2.0}


def both(name, args_of):
    """Run `name` through both dispatchers; args_of(tag) gives each run's
    arguments ("j" for the reference, "t" for the port). Returns the two
    programs and their standard output."""
    progs, outs = [], []
    for tag, get in (("j", jax_program), ("t", get_program)):
        prog, out = get(name), io.StringIO()
        tail = ["-v", "0"] + (["--device", "cpu"] if tag == "t" else [])
        with redirect_stdout(out):
            assert prog.run_with_args(
                [str(a) for a in args_of(tag)] + tail) == 0, tag
        progs.append(prog)
        outs.append(out.getvalue())
    return progs, outs


def stack(path):
    return np.asarray(Image.read_stack(str(path)), np.float64)


def same_rows(a, b, tols=None):
    """Rows equal, but for the labels in tols (label -> absolute tol)."""
    tols = tols or {}
    assert len(a) == len(b) and len(a)
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for k in ra:
            if k in tols:
                assert abs(float(ra[k]) - float(rb[k])) <= tols[k], k
            else:
                assert ra[k] == rb[k], (k, ra[k], rb[k])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The particle, the coordinates, and the reference's simulated tilt
    series and tomogram (the port's next to them)."""
    d = tmp_path_factory.mktemp("tomo")
    for t in "jt":
        (d / t).mkdir()
    save_image(str(d / "part.vol"), phantom8(BOX))
    rng = np.random.default_rng(7)
    xy = [(-12, -11), (11, -10), (-10, 12), (12, 11)]
    MetaData.fromRows(
        {"xcoor": x, "ycoor": y, "zcoor": int(rng.integers(-2, 3)),
         "angleRot": float(rng.uniform(0, 360)),
         "angleTilt": float(rng.uniform(0, 180)),
         "anglePsi": float(rng.uniform(0, 360))} for x, y in xy
    ).write(str(d / "coords.xmd"))
    MetaData.fromRows({"xcoor": x, "ycoor": y, "zcoor": z}
                      for x, y, z in [(0, 0, 1), (-18, 2, -3), (17, -1, 2)]
                      ).write(str(d / "fid.xmd"))
    both("tomo_simulate_tilt_series", lambda t: [
        "--coordinates", d / "coords.xmd", "--vol", d / "part.vol",
        "--tiltseries", d / t / "ts.mrcs", "--tomogram", d / t / "tomo.mrc",
        "--xdim", X, "--ydim", X, "--thickness", Z, *TILTS,
        "--fiducialCoordinates", d / "fid.xmd", "--fiducialDiameter", 4,
        "--sigmaNoise", 0.2])
    return d


def test_simulate_tilt_series_matches_the_reference(data):
    d = data
    assert np.array_equal(vol(d / "t" / "tomo.mrc"), vol(d / "j" / "tomo.mrc"))
    want = stack(d / "j" / "ts.mrcs")
    assert want.shape == (11, X, X)
    assert rel(stack(d / "t" / "ts.mrcs"), want) <= 1e-5
    same_rows(rows(d / "t" / "ts.xmd"), [
        dict(r, image=r["image"].replace("/j/", "/t/"))
        for r in rows(d / "j" / "ts.xmd")])


def test_tomo_project_and_its_alias(data):
    d = data
    for name in ("tomo_project", "project_tomography"):
        both(name, lambda t: ["-i", d / "part.vol", "-o",
                              d / t / name, "--tiltRange", -45, 45, 15])
        assert rel(stack(d / "t" / f"{name}.mrcs"),
                   stack(d / "j" / f"{name}.mrcs")) <= 1e-5
    assert type(get_program("project_tomography")) is \
        type(get_program("tomo_project"))


def test_dose_filter_square_matches_the_reference(data):
    d = data
    both("tomo_tiltseries_dose_filter", lambda t: [
        "-i", d / "j" / "ts.xmd", "-o", d / t / "dose.mrcs",
        "--dosePerImage", 3, "--sampling", 2, "--voltage", 200])
    assert rel(stack(d / "t" / "dose.mrcs"), stack(d / "j" / "dose.mrcs")) \
        <= 1e-5


def test_dose_filter_non_square_series(data, tmp_path):
    """ROADMAP.md section 3, item 7: the weights take the images' width.
    The reference's square weights do not fit the spectra; the port's
    equal float64 numpy weights of the published fit on the rfft grid."""
    series = stack(data / "j" / "ts.mrcs")[:, 4:36, :].astype(np.float32)
    save_image(str(tmp_path / "ns.mrcs"), series)
    args = ["-i", tmp_path / "ns.mrcs", "--dosePerImage", 2.5,
            "--sampling", 1.5]
    with redirect_stdout(io.StringIO()):
        with pytest.raises(Exception):
            jax_program("tomo_tiltseries_dose_filter").run_with_args(
                [str(a) for a in args] + ["-o", str(tmp_path / "j.mrcs"),
                                          "-v", "0"])
    assert get_program("tomo_tiltseries_dose_filter").run_with_args(
        [str(a) for a in args] + ["-o", str(tmp_path / "t.mrcs"), "-v", "0",
                                  "--device", "cpu"]) == 0
    F, H, W = series.shape
    k = np.sqrt(np.fft.fftfreq(H)[:, None] ** 2
                + np.fft.rfftfreq(W)[None, :] ** 2) / 1.5
    Nc = 0.24499 * np.maximum(k, 1e-6) ** -1.6649 + 2.8141
    q = np.exp(-2.5 * (np.arange(F) + 1)[:, None, None] / (2 * Nc[None]))
    want = np.fft.irfft2(np.fft.rfft2(series.astype(np.float64)) * q,
                         s=(H, W))
    assert rel(stack(tmp_path / "t.mrcs"), want) <= 1e-5


def test_tomogram_reconstruction_matches_the_reference(data):
    d = data
    both("tomogram_reconstruction", lambda t: [
        "-i", d / "j" / "ts.xmd", "-o", d / t / "rec.mrc", "--thickness", Z])
    want = vol(d / "j" / "rec.mrc")
    assert want.shape == (Z, X, X)
    assert rel(vol(d / "t" / "rec.mrc"), want) <= 5e-3
    # a stack and --tiltRange give the same map
    assert get_program("tomogram_reconstruction").run_with_args([
        "-i", str(d / "j" / "ts.mrcs"), "-o", str(d / "t" / "rec2.mrc"),
        "--thickness", str(Z), *map(str, TILTS), "-v", "0", "--device",
        "cpu"]) == 0
    assert np.array_equal(vol(d / "t" / "rec2.mrc"), vol(d / "t" / "rec.mrc"))


def test_tomogram_reconstruction_refuses_a_non_square_series(data, tmp_path):
    """ROADMAP.md section 3, item 23: the reference raises TypeError in its
    gridding; the port refuses the series with a message."""
    save_image(str(tmp_path / "ns.mrcs"),
               stack(data / "j" / "ts.mrcs")[:, :40].astype(np.float32))
    args = ["-i", str(tmp_path / "ns.mrcs"), "-v", "0"]
    with pytest.raises(TypeError):
        jax_program("tomogram_reconstruction").run_with_args(
            args + ["-o", str(tmp_path / "j.mrc")])
    err = io.StringIO()
    with redirect_stderr(err):
        assert get_program("tomogram_reconstruction").run_with_args(
            args + ["-o", str(tmp_path / "t.mrc"), "--device", "cpu"]) == 1
    assert "item 23" in err.getvalue()


def test_detect_landmarks_matches_the_reference(data):
    d = data
    (pj, pt), _ = both("tomo_detect_landmarks", lambda t: [
        "-i", d / "j" / "ts.xmd", "-o", d / t / "lm.xmd", "--fiducialSize",
        8, "--targetLMsize", 4, "--thrSD", 3])
    assert pt.n_landmarks == pj.n_landmarks > 0
    a, b = rows(d / "t" / "lm.xmd"), rows(d / "j" / "lm.xmd")
    cost = max(abs(r["cost"]) for r in b)
    same_rows(a, b, {"cost": 1e-4 * cost})


def test_landmark_residuals_verdicts_and_statistics(data):
    d = data
    fid = MetaData.fromRows(
        {"xcoor": x + X // 2, "ycoor": y + X // 2, "zcoor": z}
        for x, y, z in [(0, 0, 1), (-18, 2, -3), (17, -1, 2)])
    fid.write(str(d / "fid3d.xmd"))
    both("tomo_calculate_landmark_residuals", lambda t: [
        "-i", d / "j" / "ts.xmd", "--tlt", d / "j" / "ts.xmd",
        "--inputCoord", d / "fid3d.xmd", "-o", d / t / "res.xmd",
        "--fiducialSize", 4, "--thrSDHCC", 2])
    a, b = rows(d / "t" / "res.xmd"), rows(d / "j" / "res.xmd")
    same_rows(a, b, {k: 1e-4 for k in ("x", "y", "shiftX", "shiftY")})
    # the verdicts and the statistics read the reference's residuals
    for extra in ([], ["--removeOutliers"]):
        both("tomo_detect_misalignment_residuals", lambda t: [
            "--inputResInfo", d / "j" / "res.xmd", "-o",
            d / t / "verdict.xmd", "--thrRatioMahalanobis", 0.5, *extra])
        same_rows(rows(d / "t" / "verdict.xmd"), rows(d / "j" / "verdict.xmd"))
        assert open(d / "t" / "verdict.xmd").read() == \
            open(d / "j" / "verdict.xmd").read()
    (d / "list.txt").write_text(f"{d / 'j' / 'res.xmd'}\n"
                                f"{d / 'j' / 'res.xmd'}\n")
    for src in (d / "j" / "res.xmd", d / "list.txt"):
        both("tomo_misalignment_resid_statistics", lambda t: [
            "-i", src, "-o", d / t / "stats.xmd"])
        same_rows(rows(d / "t" / "stats.xmd"), rows(d / "j" / "stats.xmd"))


def test_missing_wedge_matches_the_reference(data):
    d = data
    # the whole reconstructed volume (its wedge about y); each package
    # reads its own copy, as it writes the marks and the mask beside it
    both("tomogram_reconstruction", lambda t: [
        "-i", d / "j" / "ts.xmd", "-o", d / t / "wedge.mrc"])
    save_image(str(d / "t" / "wedge.mrc"), vol(d / "j" / "wedge.mrc")
               .astype(np.float32))
    (pj, pt), (oj, ot) = both("tomo_detect_missing_wedge", lambda t: [
        "-i", d / t / "wedge.mrc", "--saveMarks", "--saveMask",
        "--maxFreq", 0.3])
    assert pt.planes == pj.planes and pt.wedge == pj.wedge
    assert ot == oj
    assert np.array_equal(vol(d / "t" / "wedge_mask.vol"),
                          vol(d / "j" / "wedge_mask.vol"))
    # dB magnitudes: inside the missing wedge |F| is the FFTs' float32
    # roundoff, which 20 log10 turns into noise; they are held where |F|
    # (in float64) is at least 1e-3 of its max
    mag = np.abs(np.fft.fftn(vol(d / "j" / "wedge.mrc")))
    well = mag >= 1e-3 * mag.max()
    assert well.mean() >= 0.1          # read 0.19
    want = vol(d / "j" / "wedge_marks.vol")
    assert rel(vol(d / "t" / "wedge_marks.vol")[well], want[well]) <= 1e-5


def test_peak_high_contrast_matches_the_reference(data):
    d = data
    (pj, pt), _ = both("image_peak_high_contrast", lambda t: [
        "--vol", d / "j" / "tomo.mrc", "-o", d / t / "beads.xmd",
        "--fiducialSize", 4, "--boxSize", 8, "--numberOfCoordinatesThr", 3,
        "--sdThr", 3])
    assert pt.n_peaks == pj.n_peaks > 0
    same_rows(rows(d / "t" / "beads.xmd"), rows(d / "j" / "beads.xmd"))
    for src in ("tomo.mrc", "ts.mrcs"):
        img = d / "j" / src if src == "tomo.mrc" else \
            f"3@{d / 'j' / 'ts.mrcs'}"
        (pj, pt), _ = both("image_peak_high_contrast", lambda t: [
            "-i", img, "-o", d / t / "peaks.xmd", "--thr", 3,
            "--boxSize", 4])
        assert pt.n_peaks == pj.n_peaks > 0
        same_rows(rows(d / "t" / "peaks.xmd"), rows(d / "j" / "peaks.xmd"))


def test_filter_coordinates_matches_the_reference(data):
    d = data
    mask = np.zeros((Z, X, X), np.float32)
    mask[:, :, :30] = 1
    save_image(str(d / "cmask.mrc"), mask)
    MetaData.fromRows(
        {"xcoor": x, "ycoor": y, "zcoor": z, "cost": c}
        for x, y, z, c in [(12, 12, 8, 1.0), (20, 30, 7, 0.2),
                           (40, 20, 8, 3.0), (26, 24, 8, 2.0),
                           (2, 30, 8, 5.0)]).write(str(d / "c3d.xmd"))
    both("tomo_filter_coordinates", lambda t: [
        "--coordinates", d / "c3d.xmd", "-o", d / t / "filt.xmd",
        "--inTomo", d / "j" / "tomo.mrc", "--radius", 6, "--mask",
        d / "cmask.mrc", "--minScore", 0.5])
    a, b = rows(d / "t" / "filt.xmd"), rows(d / "j" / "filt.xmd")
    assert len(b) == 2
    same_rows(a, b, {k: 1e-9 * max(abs(r[k]) for r in b)
                     for k in ("avg", "stddev")})


@pytest.fixture(scope="module")
def subtomos(data):
    """Coordinates of the 4 particles in the tomogram's frame, and one too
    close to its border to extract."""
    d = data
    MetaData.fromRows({"xcoor": x + X // 2, "ycoor": y + X // 2,
                       "zcoor": Z // 2 + z}
                      for x, y, z in [(-12, -11, 0), (11, -10, 0),
                                      (-10, 12, 0), (12, 11, 0), (0, 23, 0)]
                      ).write(str(d / "sub_coords.xmd"))
    return d


@pytest.mark.parametrize("flags", [
    ["--boxsize", 12], ["--boxsize", 12, "--invertContrast", "--normalize"],
    ["--boxsize", 6, "--downsample", 2, "--fixedBoxSize", "--normalize"]])
def test_extract_subtomograms_matches_the_reference(subtomos, flags):
    d = subtomos
    (pj, pt), _ = both("tomo_extract_subtomograms", lambda t: [
        "--tomogram", d / "j" / "tomo.mrc", "--coordinates",
        d / "sub_coords.xmd", "-o", d / t / "sub", *flags])
    assert pt.n_extracted == pj.n_extracted == 4
    a, b = rows(d / "t" / "sub.xmd"), rows(d / "j" / "sub.xmd")
    same_rows([{k: v for k, v in r.items() if k != "subtomoName"} for r in a],
              [{k: v for k, v in r.items() if k != "subtomoName"} for r in b])
    for ra, rb in zip(a, b):
        assert rel(vol(ra["subtomoName"]), vol(rb["subtomoName"])) <= 1e-5


def test_average_subtomos_and_map_back(subtomos):
    d = subtomos
    both("tomo_extract_subtomograms", lambda t: [
        "--tomogram", d / "j" / "tomo.mrc", "--coordinates",
        d / "sub_coords.xmd", "-o", d / t / "avg_in", "--boxsize", 12])
    rng = np.random.default_rng(2)
    posed = [dict(r, angleRot=float(rng.uniform(0, 90)),
                  angleTilt=float(rng.uniform(0, 40)),
                  anglePsi=float(rng.uniform(0, 90)),
                  shiftX=float(rng.uniform(-1, 1)), shiftZ=0.5)
             for r in rows(d / "j" / "avg_in.xmd")]
    MetaData.fromRows(posed).write(str(d / "posed.xmd"))
    both("tomo_average_subtomos", lambda t: [
        "-i", d / "posed.xmd", "-o", d / t / "avg.mrc", "--goldStandard",
        "--seed", 3])
    for fn in ("avg.mrc", "halfMap_1.mrc", "halfMap_2.mrc"):
        assert rel(vol(d / "t" / fn), vol(d / "j" / fn)) <= 1e-5, fn
    both("tomo_average_subtomos", lambda t: [
        "-i", d / "posed.xmd", "-o", d / t / "raw.mrc",
        "--notApplyAlignment"])
    assert rel(vol(d / "t" / "raw.mrc"), vol(d / "j" / "raw.mrc")) <= 1e-5
    for method in (["copy"], ["avg", 0.2], ["highlight", 2.0],
                   ["copy_binary", 0.3]):
        both("tomo_map_back", lambda t: [
            "-i", d / "j" / "tomo.mrc", "-o", d / t / "mb.mrc", "--geom",
            d / "posed.xmd", "--ref", d / "part.vol", "--method", *method])
        assert rel(vol(d / "t" / "mb.mrc"), vol(d / "j" / "mb.mrc")) <= 1e-5


def test_subtomo_subtraction_and_its_alias(subtomos):
    d = subtomos
    both("tomo_extract_subtomograms", lambda t: [
        "--tomogram", d / "j" / "tomo.mrc", "--coordinates",
        d / "sub_coords.xmd", "-o", d / t / "ss_in", "--boxsize", 12])
    save_image(str(d / "ref12.vol"), phantom8(12))
    src = rows(d / "j" / "ss_in.xmd")[:2]
    MetaData.fromRows([dict(src[0]), dict(src[1], angleRot=20.0,
                                          angleTilt=10.0, shiftX=1.0)]
                      ).write(str(d / "ss.xmd"))
    for name, extra in (("subtomo_subtraction", ["--sub", "--iter", 3]),
                        ("mpi_subtomo_subtraction",
                         ["--iter", 2, "--radavg", "--cutFreq", 0.3])):
        both(name, lambda t: [
            "-i", d / "ss.xmd", "--ref", d / "ref12.vol", "--oroot",
            d / t / "ss_out", "--saveV1", d / t / "v1.mrc", "--saveV2",
            d / t / "v2.mrc", *extra])
        a, b = rows(d / "t" / "ss_out.xmd"), rows(d / "j" / "ss_out.xmd")
        for ra, rb in zip(a, b):
            assert rel(vol(ra["subtomoName"]), vol(rb["subtomoName"])) \
                <= 1e-4, name
    assert type(get_program("mpi_subtomo_subtraction")) is \
        type(get_program("subtomo_subtraction"))


def test_ctf_wiener2d_correction_matches_the_reference(data):
    d = data
    MetaData.fromRows(dict(r, ctfDefocusU=12000.0 + 400 * i,
                           ctfDefocusV=12500.0 + 400 * i,
                           ctfDefocusAngle=30.0, **CTF_ROW)
                      for i, r in enumerate(rows(d / "j" / "ts.xmd"))
                      ).write(str(d / "ts_ctf.xmd"))
    both("tomo_ctf_wiener2d_correction", lambda t: [
        "-i", d / "ts_ctf.xmd", "-o", d / t / "wiener.mrcs", "--sampling",
        2, "--wc", 0.05])
    assert rel(stack(d / "t" / "wiener.mrcs"),
               stack(d / "j" / "wiener.mrcs")) <= 1e-5


def test_extract_particlestacks_matches_the_reference(data):
    d = data
    MetaData.fromRows(dict(r, ctfDefocusU=12000.0, ctfDefocusV=12400.0,
                           ctfDefocusAngle=10.0)
                      for r in rows(d / "j" / "ts.xmd")
                      ).write(str(d / "ts_def.xmd"))
    MetaData.fromRows({"xcoor": x, "ycoor": y, "zcoor": z}
                      for x, y, z in [(12, 13, 1), (35, 14, -2), (14, 37, 0)]
                      ).write(str(d / "p3d.xmd"))
    both("tomo_extract_particlestacks", lambda t: [
        "--tiltseries", d / "ts_def.xmd", "--coordinates", d / "p3d.xmd",
        "--boxsize", 16, "-o", d / t / "pst", "--sampling", 2,
        "--normalize", "--invertContrast", "--setCTF", "--defocusPositive"])
    a, b = rows(d / "t" / "pst" / "particlestacks.xmd"), \
        rows(d / "j" / "pst" / "particlestacks.xmd")
    strip = lambda rs: [{k: v for k, v in r.items() if k != "image"}
                        for r in rs]
    same_rows(strip(a), strip(b))
    for n in (1, 2, 3):
        fn = f"particle_{n:05d}.mrcs"
        assert rel(stack(d / "t" / "pst" / fn), stack(d / "j" / "pst" / fn)) \
            <= 1e-5


def test_align_tilt_pairs_matches_the_reference(tmp_path):
    from xmipp3_tpu_torch.ops.geo import apply_affine_2d
    from xmipp3_tpu_torch.ops.project import FourierProjector
    d = tmp_path
    for t in "jt":
        (d / t).mkdir()
    n, B = 32, 6
    rng = np.random.default_rng(5)
    ref = FourierProjector(phantom8(n), device="cpu").project_euler(
        [0.0], [0.0], [0.0]).numpy()[0]
    save_image(str(d / "ref.xmp"), ref)
    rs = []
    for i in range(B):
        tilt = float(rng.uniform(30, 50))
        s = np.cos(np.deg2rad(tilt))
        A = np.array([[s, 0, rng.uniform(-2, 2)], [0, 1, rng.uniform(-2, 2)],
                      [0, 0, 1]], np.float32)
        img = apply_affine_2d(ref[None], A[None], device="cpu").numpy()[0]
        save_image(str(d / f"t{i}.xmp"), img)
        rs.append({"imageTilted": str(d / f"t{i}.xmp"), "image": "u.xmp",
                   "angleTilt": tilt, "anglePsi": float(rng.uniform(-5, 5)),
                   "angleY": float(rng.uniform(-10, 10)),
                   "angleY2": float(rng.uniform(-10, 10)),
                   "shiftX": float(rng.uniform(-1, 1)),
                   "shiftY": float(rng.uniform(-1, 1)), "flip": i % 3 == 2})
    MetaData.fromRows(rs).write(str(d / "pairs.xmd"))
    for extra in ([], ["--do_stretch"], ["--max_shift", 3]):
        (pj, pt), _ = both("image_align_tilt_pairs", lambda t: [
            "-i", d / "pairs.xmd", "-o", d / t / "al.xmd", "--ref",
            d / "ref.xmp", *extra])
        assert pt.n_discarded == pj.n_discarded
        same_rows(rows(d / "t" / "al.xmd"), rows(d / "j" / "al.xmd"),
                  {"shiftX": 1e-3, "shiftY": 1e-3, "angleRot": 1e-9,
                   "angleTilt": 1e-9, "anglePsi": 1e-9})


def tilt_pair_coordinates(seed, n=40, tilt=40.0):
    """Untilted positions, their tilted images (x compressed by cos(tilt),
    rotated 10 degrees, shifted, 0.5 px of noise), shuffled, with 4 spare
    points on each side."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(50, 950, (n, 2))
    a = np.deg2rad(10.0)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    A = R @ np.diag([np.cos(np.deg2rad(tilt)), 1.0])
    t = u @ A.T + [60.0, -20.0] + rng.normal(0, 0.5, (n, 2))
    u = np.concatenate([u, rng.uniform(50, 950, (4, 2))])
    t = np.concatenate([t, rng.uniform(50, 950, (4, 2))])[rng.permutation(
        n + 4)]
    return u, t


def test_assignment_tilt_pair_matches_the_reference(tmp_path):
    d = tmp_path
    u, t = tilt_pair_coordinates(3)
    for name, P in (("u.xmd", u), ("t.xmd", t)):
        MetaData.fromRows({"xcoor": int(x), "ycoor": int(y)} for x, y in P
                          ).write(str(d / name))
    for tag in "jt":
        (d / tag).mkdir()
    for extra in ([], ["--tiltangle", 40, "--particlesize", 30],
                  ["--no_delaunay", "--maxshift", 5]):
        (pj, pt), _ = both("image_assignment_tilt_pair", lambda tag: [
            "--untiltcoor", d / "u.xmd", "--tiltcoor", d / "t.xmd",
            "--odir", d / tag, *extra])
        assert pt.n_pairs == pj.n_pairs >= 30
        for fn in ("untilted_assigned.xmd", "tilted_assigned.xmd"):
            same_rows(rows(d / "t" / fn), rows(d / "j" / fn))


@pytest.mark.parametrize("name,args", [
    ("tomo_calculate_landmark_residuals", ["--targetLMsize", 6]),
    ("tomo_detect_misalignment_residuals", ["--samplingRate", 2]),
    ("tomo_detect_misalignment_residuals", ["--fiducialSize", 50])])
def test_flags_the_reference_never_reads_are_refused(data, name, args):
    """ROADMAP.md section 3, item 24."""
    d = data
    base = {"tomo_calculate_landmark_residuals": [
        "-i", d / "j" / "ts.xmd", "--tlt", d / "j" / "ts.xmd",
        "--inputCoord", d / "fid.xmd", "-o", d / "t" / "x.xmd"],
        "tomo_detect_misalignment_residuals": [
        "--inputResInfo", d / "j" / "ts.xmd", "-o", d / "t" / "x.xmd"]}[name]
    err = io.StringIO()
    with redirect_stderr(err):
        assert get_program(name).run_with_args(
            [str(a) for a in base + args] + ["--device", "cpu", "-v",
                                             "0"]) == 1
    assert "item 24" in err.getvalue()


@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_new_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__
