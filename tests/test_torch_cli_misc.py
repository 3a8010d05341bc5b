"""The remaining utility programs (misc_programs) against the reference
package's on the same files, on the CPU (the 8-blob phantom at N=32,
24 views at known poses, 32^3 volumes), the port with --device cpu; the
reference's alias of them, its grammar, and the flag it declares and
never reads, which the port refuses.

Tolerances, relative to the max of the reference's output where not said:
- transform_dimred: with --distance Euclidean the embeddings up to each
  axis's sign 1e-6 (float64 on both sides); with the default Correlation
  distance (the views aligned to their average first) 1e-3 (read 3e-4:
  the two alignments' float32 roundoff); --randomSample the same rows;
- angular_distribution_show, image_odd_even, transform_morphology: equal
  (host numpy and scipy in both);
- transform_adjust_image_grey_levels: a and b 1e-5 absolute, the images
  1e-5 (the same closed form on float32 views and low-passed images);
- local_volume_adjust: 1e-6 of the input's max, --save's occupancy 1e-6;
- volume_local_sharpening: the same iteration count and lambda 1e-5
  relative, the map 1e-4 (float32 band sweeps of irfftn);
- transform_center_image: the shifts 1e-4 px absolute and the images 1e-4
  (the same shift estimates and Fourier shifts in float32).
"""
import numpy as np
import pytest
import torch

from test_torch_cli_analysis import aligned, both, rel, rows, vol
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.project import FourierProjector
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

N, B = 32, 24
NEW = ["transform_dimred", "angular_distribution_show", "image_odd_even",
       "transform_adjust_image_grey_levels", "local_volume_adjust",
       "volume_local_sharpening", "transform_morphology",
       "transform_center_image"]
NEW_ALIASES = ["mpi_transform_adjust_image_grey_levels"]
PLANT_AB = (1.03, 0.02)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The phantom; 24 clean and noisy views at known poses, the clean
    ones with a planted grey-level change, the noisy ones shifted; 32^3
    volumes for the local adjustment and sharpening."""
    d = tmp_path_factory.mktemp("misc")
    for t in "jt":
        (d / t).mkdir()
    v = phantom8(N)
    save_image(str(d / "vol.vol"), v)
    rng = np.random.default_rng(13)
    rot = rng.uniform(0, 360, B).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, B))).astype(np.float32)
    psi = rng.uniform(0, 360, B).astype(np.float32)
    P = FourierProjector(v, device="cpu").project_euler(rot, tilt, psi) \
        .numpy()
    a, b = PLANT_AB
    grey = (a * P + b * P.std()).astype(np.float32)
    noisy = (P + 0.2 * P.std() * rng.standard_normal(P.shape)).astype(
        np.float32)
    shifted = np.roll(noisy, (2, -1), (1, 2))
    for name, stack in (("grey", grey), ("views", noisy),
                        ("shifted", shifted)):
        stk = str(d / f"{name}.mrcs")
        save_image(stk, stack)
        MetaData.fromRows(
            {"image": f"{i + 1}@{stk}", "angleRot": float(rot[i]),
             "angleTilt": float(tilt[i]), "anglePsi": float(psi[i]),
             "itemId": i + 1, "enabled": 1}
            for i in range(B)).write(str(d / f"{name}.xmd"))
    # local adjustment: v scaled by 1.5 in one 8^3 block
    scaled = v.copy()
    scaled[8:16, 8:16, 16:24] *= 1.5
    save_image(str(d / "scaled.vol"), scaled)
    zz, yy, xx = np.mgrid[:N, :N, :N] - N // 2
    r = np.sqrt(zz ** 2 + yy ** 2 + xx ** 2)
    save_image(str(d / "mask.vol"), (r < 14).astype(np.float32))
    # sharpening: a two-zone resolution map (3 A inside r < 8, 6 A to 14,
    # nothing measured outside)
    res = np.where(r < 8, 3.0, np.where(r < 14, 6.0, 0.0)).astype(
        np.float32)
    save_image(str(d / "res.vol"), res)
    save_image(str(d / "blurred.vol"), np.asarray(
        np.fft.irfftn(np.fft.rfftn(v) * np.exp(
            -40 * (np.fft.fftfreq(N)[:, None, None] ** 2
                   + np.fft.fftfreq(N)[None, :, None] ** 2
                   + np.fft.rfftfreq(N)[None, None, :] ** 2)), v.shape,
        axes=(0, 1, 2)),
        np.float32))
    # binary images and a binary volume for the morphology
    save_image(str(d / "binary.mrcs"),
               (noisy > 0.5 * noisy.max()).astype(np.float32))
    save_image(str(d / "binary.vol"), (v > 0.3).astype(np.float32))
    return d


# -- transform_dimred ------------------------------------------------------

@pytest.mark.parametrize("distance,tol", [("Euclidean", 1e-6),
                                          ("Correlation", 1e-3)])
def test_transform_dimred_matches_the_reference(data, distance, tol):
    d = data
    both("transform_dimred", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / f"dr_{distance}.xmd"),
        "--method", "PCA", "--dout", "3", "--distance", distance,
        "--randomSample", str(d / t / f"rs_{distance}.xmd"), "3"])
    got = np.stack([r["dimred"] for r in rows(d / "t" /
                                              f"dr_{distance}.xmd")])
    want = np.stack([r["dimred"] for r in rows(d / "j" /
                                               f"dr_{distance}.xmd")])
    assert rel(aligned(got, want), want) <= tol
    # --randomSample: the row nearest each cell of a 3 x 3 grid over the
    # first two axes; the port's picks follow that rule on its own
    # embedding, and equal the reference's where the signs agree
    pick = lambda t: [r["itemId"] for r in rows(d / t /
                                                 f"rs_{distance}.xmd")]
    lo, hi = got[:, :2].min(axis=0), got[:, :2].max(axis=0)
    want_picks = []
    for gy in range(3):
        for gx in range(3):
            c = lo + (np.array([gx, gy]) + 0.5) / 3 * (hi - lo)
            k = int(np.argmin(((got[:, :2] - c) ** 2).sum(axis=1)))
            if k + 1 not in want_picks:
                want_picks.append(k + 1)
    assert pick("t") == want_picks
    if ((got[:, :2] * want[:, :2]).sum(axis=0) > 0).all():
        assert pick("t") == pick("j")


# -- angular_distribution_show and image_odd_even -----------------------------

@pytest.mark.parametrize("flags", [[], ["--up_down_correction"]])
def test_angular_distribution_show_matches_the_reference(data, flags):
    d = data
    j, t = both("angular_distribution_show", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / "dist.xmd"),
        "--sampling", "15"] + flags)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert rows(d / "t" / "dist.xmd") == rows(d / "j" / "dist.xmd")


@pytest.mark.parametrize("src,ext", [("views.mrcs", "mrcs"),
                                     ("views.xmd", "xmd")])
def test_image_odd_even_matches_the_reference(data, src, ext):
    d = data
    both("image_odd_even", lambda t: [
        "-i", str(d / src), "-o", str(d / t / f"odd.{ext}"),
        "-e", str(d / t / f"even.{ext}"), "--sum_frames", "--type",
        "images"])
    for name in (f"odd_avg.mrc", f"even_avg.mrc"):
        np.testing.assert_array_equal(vol(d / "t" / name),
                                      vol(d / "j" / name))
    for name in (f"odd.{ext}", f"even.{ext}"):
        if ext == "xmd":
            assert rows(d / "t" / name) == rows(d / "j" / name)
        else:
            np.testing.assert_array_equal(vol(d / "t" / name),
                                          vol(d / "j" / name))


# -- transform_adjust_image_grey_levels ----------------------------------------

@pytest.mark.parametrize("name", ["transform_adjust_image_grey_levels",
                                  "mpi_transform_adjust_image_grey_levels"])
def test_adjust_grey_levels_matches_the_reference(data, name):
    d = data
    both(name, lambda t: [
        "-i", str(d / "grey.xmd"), "-o", str(d / t / "adj.mrcs"),
        "--save_metadata_stack", str(d / t / "adj.xmd"), "--ref",
        str(d / "vol.vol"), "--max_resolution", "3", "--max_gray_scale",
        "0.1", "--max_gray_shift", "0.2", "--Rmax", "12"])
    got, want = rows(d / "t" / "adj.xmd"), rows(d / "j" / "adj.xmd")
    for k in ("continuousA", "continuousB"):
        np.testing.assert_allclose([r[k] for r in got],
                                   [r[k] for r in want], atol=1e-5)
    assert rel(vol(d / "t" / "adj.mrcs"), vol(d / "j" / "adj.mrcs")) <= 1e-5
    # the planted scale is found inside its box
    a = np.array([r["continuousA"] for r in got])
    assert np.median(np.abs(a - PLANT_AB[0])) < 0.01


# -- local_volume_adjust ----------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--sub"],
                                   ["--mask", "MASK", "--neighborhood", "4"]])
def test_local_volume_adjust_matches_the_reference(data, flags):
    d = data
    flags = [str(d / "mask.vol") if f == "MASK" else f for f in flags]
    tag = "_".join(f.strip("-") for f in flags[:1]) or "plain"
    for t in "jt":
        (d / t / tag).mkdir(exist_ok=True)
    both("local_volume_adjust", lambda t: [
        "--i1", str(d / "vol.vol"), "--i2", str(d / "scaled.vol"),
        "-o", str(d / t / f"lva_{tag}.vol"), "--neighborhood", "8",
        "--save", str(d / t / tag)] + flags)
    # relative to the input's max: with --sub the output is the
    # difference V1 - min(V', V1), about 0 where the scales are recovered
    scale = np.abs(vol(d / "vol.vol")).max()
    assert np.abs(vol(d / "t" / f"lva_{tag}.vol")
                  - vol(d / "j" / f"lva_{tag}.vol")).max() <= 1e-6 * scale
    assert rel(vol(d / "t" / tag / "Occupancy.mrc"),
               vol(d / "j" / tag / "Occupancy.mrc")) <= 1e-6
    if not flags:     # the planted block scale comes back
        occ = vol(d / "t" / tag / "Occupancy.mrc")
        assert occ[8:16, 8:16, 16:24] == pytest.approx(1.5, rel=1e-5)


# -- volume_local_sharpening ----------------------------------------------------

def test_volume_local_sharpening_matches_the_reference(data):
    d = data
    j, t = both("volume_local_sharpening", lambda t: [
        "--vol", str(d / "blurred.vol"), "--resolution_map",
        str(d / "res.vol"), "-o", str(d / t / "sharp.vol"), "--md",
        str(d / t / "sharp.xmd"), "--sampling", "1", "-i", "6"])
    got, want = rows(d / "t" / "sharp.xmd"), rows(d / "j" / "sharp.xmd")
    assert got[0]["iterationNumber"] == want[0]["iterationNumber"]
    assert got[0]["cost"] == pytest.approx(want[0]["cost"], rel=1e-5)
    assert rel(vol(d / "t" / "sharp.vol"), vol(d / "j" / "sharp.vol")) \
        <= 1e-4


# -- transform_morphology -------------------------------------------------------

@pytest.mark.parametrize("src,flags", [
    ("binary.mrcs", ["--binaryOperation", "dilation", "--size", "2"]),
    ("binary.mrcs", ["--binaryOperation", "closing", "--neigh2D",
                     "Neigh4"]),
    ("binary.mrcs", ["--binaryOperation", "erosion", "--count", "3"]),
    ("binary.mrcs", ["--binaryOperation", "removeSmall", "5"]),
    ("binary.vol", ["--binaryOperation", "keepBiggest", "--neigh3D",
                    "Neigh6"]),
    ("binary.vol", ["--binaryOperation", "opening", "--neigh3D",
                    "Neigh26"]),
    ("views.mrcs", ["--grayOperation", "sharpening", "1", "0.6"])])
def test_transform_morphology_matches_the_reference(data, src, flags):
    d = data
    ext = src.split(".")[1]
    tag = "_".join(f.strip("-") for f in flags)
    both("transform_morphology", lambda t: [
        "-i", str(d / src), "-o", str(d / t / f"mo_{tag}.{ext}")] + flags)
    np.testing.assert_array_equal(vol(d / "t" / f"mo_{tag}.{ext}"),
                                  vol(d / "j" / f"mo_{tag}.{ext}"))


# -- transform_center_image ------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--iter", "3", "--limit", "1"]])
def test_transform_center_image_matches_the_reference(data, flags):
    d = data
    tag = "_".join(f.strip("-") for f in flags) or "plain"
    both("transform_center_image", lambda t: [
        "-i", str(d / "shifted.xmd"), "-o", str(d / t / f"c_{tag}.mrcs"),
        "--save_metadata_stack", str(d / t / f"c_{tag}.xmd"),
        "--save_metadata_transform"] + flags)
    got, want = rows(d / "t" / f"c_{tag}.xmd"), rows(d / "j" / f"c_{tag}.xmd")
    for k in ("shiftX", "shiftY"):
        np.testing.assert_allclose([r[k] for r in got],
                                   [r[k] for r in want], atol=1e-4)
    assert rel(vol(d / "t" / f"c_{tag}.mrcs"),
               vol(d / "j" / f"c_{tag}.mrcs")) <= 1e-4


# -- grammar, aliases, refused flags ----------------------------------------

@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_flags_the_reference_never_reads_are_refused(data, tmp_path,
                                                      capsys):
    assert get_program("image_odd_even").run_with_args(
        ["-i", str(data / "views.mrcs"), "--oroot", str(tmp_path / "o"),
         "--type", "frames", "--device", "cpu", "-v", "0"]) == 1
    err = capsys.readouterr().err
    assert "--type" in err and "never reads" in err
    assert not list(tmp_path.iterdir())


def test_flags_that_change_nothing_stay_accepted(data, tmp_path):
    """--Rmax (dead in the reference's cost and apply loops) and a thread
    count change nothing in the output, so the port accepts them as the
    reference does (ROADMAP.md section 3, item 19): the same output with
    and without them."""
    d = data
    runs = {
        "transform_adjust_image_grey_levels": (
            lambda o: ["-i", str(d / "grey.xmd"), "-o", o, "--ref",
                       str(d / "vol.vol")], ["--Rmax", "5"]),
        "volume_local_sharpening": (
            lambda o: ["--vol", str(d / "blurred.vol"), "--resvol",
                       str(d / "res.vol"), "-o", o, "--md",
                       str(tmp_path / "md.xmd"), "-i", "2"], ["-n", "4"])}
    for name, (args, extra) in runs.items():
        outs = []
        for k, tail in enumerate(([], extra)):
            o = str(tmp_path / f"{name}_{k}.mrc")
            assert get_program(name).run_with_args(
                args(o) + tail + ["--device", "cpu", "-v", "0"]) == 0
            outs.append(vol(o))
        np.testing.assert_array_equal(outs[1], outs[0])
