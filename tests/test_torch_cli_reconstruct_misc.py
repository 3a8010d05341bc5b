"""reconstruct_art, reconstruct_wbp, reconstruct_significant and
align_significant of the port against the reference package's programs on
the same files, on the CPU (N=32, P=64), each package on its serial path
(--mesh none where the flag defaults to auto), and significance_weights
against the reference's on a matrix with planted ties.

Tolerances, relative to the max of the reference's output:
- reconstruct_art grids its blocks with the trilinear window: volumes
  1e-4 (pSART and SIRT, --sym c4 with its symmetrised copies, the
  --noisy_reconstruction companion from the same Generator(0) noise, each
  --save_intermediate volume), residual histories 1e-5 of their first;
- reconstruct_wbp grids with the Kaiser-Bessel window, whose degree-7
  polynomial in K3's plain version stands against the reference's exact
  Bessel window: 5e-3, the kb tolerance of the port's reconstruction
  tests (arbitrary filter, --weight, --diameter, --radius);
- align_significant: the same references and flips for every image and
  rank, psi within 0.01 degrees, shifts 1e-3 px, maxCC 1e-5, the weights
  one step of the 6 decimals the .xmd holds, the updated references 1e-4;
- reconstruct_significant from given volumes, one iteration: the same
  gallery directions and flips, psi within 0.05 degrees, shifts 0.01 px,
  weights and maxCC 1e-4, volumes 5e-3 (kb); with --useImed,
  --strictDirection, --dontReconstruct and --useForValidation 3 (a
  direction or its antipode, which ties with it). With two volumes,
  images whose top merits weigh 1 in both tie between the volumes: at
  least 0.9 go to the reference's volume. Over two iterations the second gallery comes from
  the first volumes, which differ by the kb tolerance: at least 0.9 of the
  rows keep the reference's direction (read 22 of 24; the two others
  are one view twice, a near tie between two directions);
- significance_weights: equal, bit for bit, with merits tied within and
  across neighbourhoods.
"""
import numpy as np
import pytest
import torch

from test_torch_common import BLOBS, phantom_batch
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu.programs.align_significant import \
    significance_weights as jax_weights
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
from xmipp3_tpu_torch.programs import get_program
from xmipp3_tpu_torch.programs.align_significant import significance_weights

torch.set_num_threads(1)

N, C, B = 32, 40, 24
TRI, KB = 1e-4, 5e-3


# programs whose --mesh defaults to auto: both packages run their serial
# path here (--mesh none); tests/test_torch_parallel.py holds the port's
# mesh runs against the reference's on its virtual devices
MESHED = ("reconstruct_art", "reconstruct_significant")


def both(name, args_of):
    """Run `name` through both dispatchers; args_of(tag) gives each run's
    arguments ("j" for the reference, "t" for the port). Returns the two
    program objects."""
    progs = []
    for tag, get in (("j", jax_program), ("t", get_program)):
        prog = get(name)
        tail = ["-v", "0"] + (["--mesh", "none"] if name in MESHED else []) \
            + (["--device", "cpu"] if tag == "t" else [])
        assert prog.run_with_args(args_of(tag) + tail) == 0, tag
        progs.append(prog)
    return progs


def vol(path):
    return np.squeeze(Image(str(path)).data)


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def rows(path):
    md = MetaData(str(path))
    return [md.getRow(i) for i in md]


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """Phantom views with poses and shifts (and weights), each package's
    output directory."""
    d = tmp_path_factory.mktemp("recmisc")
    for t in "jt":
        (d / t).mkdir()
    b = phantom_batch(31, C, N)
    stk = str(d / "p.mrcs")
    save_image(stk, b["imgs"])
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(b["rot"][i]),
         "angleTilt": float(b["tilt"][i]), "anglePsi": float(b["psi"][i]),
         "shiftX": float(b["sx"][i]), "shiftY": float(b["sy"][i]),
         "weight": float(b["w"][i]), "itemId": i + 1}
        for i in range(C)).write(str(d / "p.xmd"))
    return d


ART = {
    "pSART": ["--parallel_mode", "pSART", "--block_size", "10", "-n", "2",
              "--POCS_positivity"],
    "SIRT_sym": ["-n", "2", "--sym", "c4", "--noisy_reconstruction",
                 "--save_intermediate", "1"],
}


@pytest.mark.parametrize("case", list(ART))
def test_reconstruct_art_matches_the_reference(rec, case):
    d = rec
    pj, pt = both("reconstruct_art", lambda t: [
        "-i", str(d / "p.xmd"), "-o", str(d / t / f"art_{case}.vol"),
        *ART[case]])
    assert rel(vol(d / "t" / f"art_{case}.vol"),
               vol(d / "j" / f"art_{case}.vol")) <= TRI
    hj, ht = pj.residual_history, pt.residual_history
    assert len(ht) == len(hj) == 2
    assert np.abs(np.array(ht) - hj).max() <= 1e-5 * hj[0]
    if case == "SIRT_sym":
        for name in ("art_SIRT_sym_noise.vol", "art_SIRT_symit0.vol",
                     "art_SIRT_symit1.vol"):
            assert rel(vol(d / "t" / name), vol(d / "j" / name)) <= TRI
        np.testing.assert_array_equal(
            vol(d / "t" / "art_SIRT_sym_noise_proj.stk"),
            vol(d / "j" / "art_SIRT_sym_noise_proj.stk"))


WBP = {"arbitrary": [], "weight_radius": ["--weight", "--radius", "12",
                                          "--filsam", "10", "--sym", "c2"],
       "diameter": ["--diameter", "20"]}


@pytest.mark.parametrize("case", list(WBP))
def test_reconstruct_wbp_matches_the_reference(rec, case):
    d = rec
    both("reconstruct_wbp", lambda t: [
        "-i", str(d / "p.xmd"), "-o", str(d / t / f"wbp_{case}.vol"),
        *WBP[case]])
    got = vol(d / "t" / f"wbp_{case}.vol")
    assert got.shape == (N, N, N)
    assert rel(got, vol(d / "j" / f"wbp_{case}.vol")) <= KB
    if case == "weight_radius":
        zz, yy, xx = np.mgrid[0:N, 0:N, 0:N] - N // 2
        assert not got[zz * zz + yy * yy + xx * xx > 144].any()


@pytest.fixture(scope="module")
def sig(tmp_path_factory):
    """A 15-degree gallery of the 8-blob phantom and B views of its
    images, moved in plane and with noise (tests/test_torch_parallel.py's
    matching set), and the 4-blob phantom as a second volume."""
    d = tmp_path_factory.mktemp("significant")
    for t in "jt":
        (d / t).mkdir()
    save_image(str(d / "vol.vol"), phantom8(N))
    z, y, x = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) - N // 2
    save_image(str(d / "vol2.vol"), sum(
        a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                   / (2 * s * s)) for cz, cy, cx, s, a in BLOBS))
    MetaData.fromRows([{"image": str(d / "vol.vol")},
                       {"image": str(d / "vol2.vol")}]).write(
                           str(d / "vols.xmd"))
    assert jax_program("angular_project_library").run_with_args(
        ["-i", str(d / "vol.vol"), "-o", str(d / "gal"), "--sampling_rate",
         "15", "-v", "0"]) == 0
    refs = np.squeeze(Image(str(d / "gal.stk")).data)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(refs), B)
    imgs = apply_alignment_2d(
        refs[idx], rng.uniform(-180, 180, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32), device="cpu").numpy()
    imgs += 0.1 * refs.std() * rng.standard_normal(imgs.shape).astype(
        np.float32)
    save_image(str(d / "views.mrcs"), imgs)
    MetaData.fromRows({"image": f"{i + 1}@{d / 'views.mrcs'}",
                       "itemId": i + 1} for i in range(B)).write(
                           str(d / "views.xmd"))
    return d


def _hold_assignments(got, want, psi, shift, value, keys=("maxCC",
                                                          "weight")):
    assert len(got) == len(want)
    for k in ("angleRot", "angleTilt", "flip", "itemId"):
        assert [r[k] for r in got] == [r[k] for r in want], k
    d = (np.array([r["anglePsi"] for r in got])
         - np.array([r["anglePsi"] for r in want]) + 180) % 360 - 180
    assert np.abs(d).max() <= psi
    for k in ("shiftX", "shiftY"):
        assert np.abs(np.array([r[k] for r in got])
                      - [r[k] for r in want]).max() <= shift, k
    for k in keys:
        assert np.abs(np.array([r[k] for r in got])
                      - [r[k] for r in want]).max() <= value, k


def test_align_significant_matches_the_reference(sig):
    d = sig
    pj, pt = both("align_significant", lambda t: [
        "-i", str(d / "views.xmd"), "-r", str(d / "gal.doc"), "-o",
        str(d / t / "as.xmd"), "--keepBestN", "2", "--oUpdatedRefs",
        str(d / t / "upd"), "--max_shift", "4", "--batch", "10"])
    got, want = rows(d / "t" / "as.xmd"), rows(d / "j" / "as.xmd")
    assert len(got) == 2 * B
    assert [r["ref"] for r in got] == [r["ref"] for r in want]
    _hold_assignments(got, want, 0.01, 1e-3, 1e-5, ("maxCC",))
    # the .xmd holds 6 decimals: the weights agree within one written step
    for k in ("weight", "weightSignificant"):
        assert np.abs(np.rint(np.array([r[k] for r in got]) * 1e6)
                      - np.rint(np.array([r[k] for r in want]) * 1e6)
                      ).max() <= 1, k
    assert rel(vol(d / "t" / "upd.stk"), vol(d / "j" / "upd.stk")) <= 1e-4
    up_t, up_j = rows(d / "t" / "upd.xmd"), rows(d / "j" / "upd.xmd")
    assert np.abs(np.array([r["weight"] for r in up_t])
                  - [r["weight"] for r in up_j]).max() <= 1e-5


SIG = {
    "one_volume": ["--initvolumes", "VOL"],
    "imed": ["--initvolumes", "VOL", "--useImed"],
    "strict": ["--initvolumes", "VOL", "--strictDirection"],
    "dont_reconstruct": ["--initvolumes", "VOL", "--dontReconstruct",
                         "--keepIntermediateVolumes"],
}


@pytest.mark.parametrize("case", list(SIG))
def test_reconstruct_significant_matches_the_reference(sig, case):
    d = sig
    sub = {"VOL": str(d / "vol.vol"), "VOLS": str(d / "vols.xmd")}

    def args(t):
        (d / t / case).mkdir(exist_ok=True)
        return ["-i", str(d / "views.xmd"), "--odir", str(d / t / case),
                "--iter", "1", "--angularSampling", "15", "--maxShift", "4",
                *[sub.get(a, a) for a in SIG[case]]]
    both("reconstruct_significant", args)
    got = rows(d / "t" / case / "significant_images.xmd")
    want = rows(d / "j" / case / "significant_images.xmd")
    _hold_assignments(got, want, 0.05, 0.01, 1e-4)
    assert [r["ref3d"] for r in got] == [r["ref3d"] for r in want]
    assert [r["enabled"] for r in got] == [r["enabled"] for r in want]
    names = sorted(p.name for p in (d / "j" / case).iterdir())
    assert names == sorted(p.name for p in (d / "t" / case).iterdir())
    for name in names:
        if name.endswith(".vol"):
            assert rel(vol(d / "t" / case / name),
                       vol(d / "j" / case / name)) <= KB


def test_reconstruct_significant_two_volumes(sig):
    """Two given volumes (the views' phantom and the 4-blob one): each
    neighbourhood's top merit weighs exactly 1, so an image whose top
    merits in both volumes weigh 1 goes to the first by argmax, or to the
    second where roundoff puts its first weight a bit below 1. At least
    0.9 of the images go to the reference's volume (read 22 of 24), and
    those that go to the views' phantom in both get the same direction."""
    d = sig

    def args(t):
        (d / t / "two").mkdir(exist_ok=True)
        return ["-i", str(d / "views.xmd"), "--odir", str(d / t / "two"),
                "--iter", "1", "--angularSampling", "15", "--maxShift", "4",
                "--initvolumes", str(d / "vols.xmd")]
    both("reconstruct_significant", args)
    got, want = ({int(r["itemId"]): r for r in rows(
        d / t / "two" / "significant_images.xmd")} for t in "tj")
    assert sorted(got) == sorted(want) == list(range(1, B + 1))
    same = [i for i in got if got[i]["ref3d"] == want[i]["ref3d"]]
    assert len(same) >= 0.9 * B
    one = [i for i in same if got[i]["ref3d"] == 1]
    assert one
    _hold_assignments([got[i] for i in one], [want[i] for i in one], 0.05,
                      0.01, 1e-4)
    for v in ("_01", "_02"):
        name = f"significant_volume{v}.vol"
        assert vol(d / "t" / "two" / name).shape == (N, N, N)


def test_reconstruct_significant_two_iterations(sig):
    d = sig

    def args(t):
        (d / t / "iter2").mkdir(exist_ok=True)
        return ["-i", str(d / "views.xmd"), "--odir", str(d / t / "iter2"),
                "--iter", "2", "--angularSampling", "15", "--maxShift", "4",
                "--initvolumes", str(d / "vol.vol")]
    pj, pt = both("reconstruct_significant", args)
    got = rows(d / "t" / "iter2" / "significant_images.xmd")
    want = rows(d / "j" / "iter2" / "significant_images.xmd")
    same = np.mean([(a["angleRot"], a["angleTilt"], a["flip"])
                    == (b["angleRot"], b["angleTilt"], b["flip"])
                    for a, b in zip(got, want)])
    assert same >= 0.9
    assert pt.volume.shape == (N, N, N) and np.isfinite(pt.volume).all()


def test_reconstruct_significant_validation_mode(sig):
    d = sig

    def args(t):
        (d / t / "valid").mkdir(exist_ok=True)
        return ["-i", str(d / "views.xmd"), "--odir", str(d / t / "valid"),
                "--angularSampling", "15", "--maxShift", "4",
                "--initvolumes", str(d / "vol.vol"), "--useForValidation",
                "3"]
    both("reconstruct_significant", args)
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    got = rows(d / "t" / "valid" / "angles_validation.xmd")
    want = rows(d / "j" / "valid" / "angles_validation.xmd")
    assert len(got) == 3 * B
    assert [r["itemId"] for r in got] == [r["itemId"] for r in want]
    # a direction and its antipode score the same against an image (its
    # projection is the mirror, and the matcher tries mirrors): such a tie
    # may list either of the two
    dirs = [directions_from_angles(np.array(
        [[r["angleRot"], r["angleTilt"]] for r in rs])) for rs in (got, want)]
    assert np.abs((dirs[0] * dirs[1]).sum(1)).min() > 1 - 1e-6
    for k, tol in (("maxCC", 1e-4), ("weight", 1e-4), ("shiftX", 0.01),
                   ("shiftY", 0.01)):
        assert np.abs(np.array([r[k] for r in got])
                      - [r[k] for r in want]).max() <= tol, k


@pytest.mark.parametrize("seed,levels", [(0, 5), (1, 2), (2, 40)])
def test_significance_weights_equal_the_reference_with_ties(seed, levels):
    """Merits on a few levels (many ties within and across the
    neighbourhoods, negative and zero merits among them), a gallery whose
    neighbourhoods hold 1 to 7 directions, and one image: the stable rank
    in (image, neighbour) order gives every tie the reference's cdf."""
    from xmipp3_tpu_torch.core.sampling import (compute_sampling_points,
                                                directions_from_angles)
    rng = np.random.default_rng(seed)
    dirs = directions_from_angles(compute_sampling_points(20.0))
    R = len(dirs)
    for Bn in (17, 1):
        cc = (rng.integers(-1, levels, (Bn, R)) / levels).astype(np.float32)
        for ang in (25.0, 10.0, 45.0):
            want = jax_weights(cc, dirs, ang)
            got = significance_weights(cc, dirs, ang, device="cpu")
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def test_significance_weights_in_groups_equal_one_group(monkeypatch):
    """The references of one neighbour count ranked a group of rows at a
    time (the byte cap lowered to one row) give the same weights."""
    from xmipp3_tpu_torch.core.sampling import (compute_sampling_points,
                                                directions_from_angles)
    from xmipp3_tpu_torch.programs import align_significant as tas
    dirs = directions_from_angles(compute_sampling_points(15.0))
    cc = np.random.default_rng(5).uniform(-0.2, 1, (9, len(dirs))).astype(
        np.float32)
    whole = significance_weights(cc, dirs, 20.0, device="cpu")
    monkeypatch.setattr(tas, "SIGNIFICANCE_CHUNK_BYTES", 1)
    np.testing.assert_array_equal(
        significance_weights(cc, dirs, 20.0, device="cpu").numpy(),
        whole.numpy())
