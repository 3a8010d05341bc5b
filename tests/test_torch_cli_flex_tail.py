"""The last eight programs of flex_misc_ext (classify_FTTRI,
classify_CLTomo_prog, volume_initial_simulated_annealing,
phantom_transform, volume_to_web, resolution_pdb_bfactor,
performance_test, write_test) against the reference package's on the same
files, on the CPU, the port with --device cpu; classify_FTTRI --mesh dp
over 2 gloo ranks against the serial run; the reference's 4 aliases of
them; the flag the reference never reads; and the registry's 218
endpoints.

Tolerances, relative to the max of the reference's output where not said:
- phantom_transform, resolution_pdb_bfactor: equal files (host text and
  numpy in both);
- volume_to_web: the slice montage equal, the projection montage 1e-6;
- classify_FTTRI (40 views of 2 classes at 32^2): the feature stack 1e-4
  (two float32 FFTs and a log of a range-adjusted magnitude; read 2e-6),
  the mask equal, the labels equal; the mesh run's labels and features
  equal to the serial run's;
- classify_CLTomo_prog (12 wedge-masked subtomograms of 2 states at
  16^3): the labels equal, the class averages 1e-6;
- volume_initial_simulated_annealing (16 views at 24^2, one random and
  one greedy round): the random round's map 5e-3 (the same draws and
  Metropolis choices; its SIRT grids with K3's plain version, the kb
  tolerance of tests/test_torch_art.py), the greedy round's poses within
  one gallery step for >= 90 % of the views, the final maps correlated
  >= 0.99;
- performance_test and write_test: their figures finite and positive
  (timings), the test file removed.
"""
import io
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

NEW = ["classify_FTTRI", "classify_CLTomo_prog",
       "volume_initial_simulated_annealing", "phantom_transform",
       "volume_to_web", "resolution_pdb_bfactor", "performance_test",
       "write_test"]
NEW_ALIASES = ["mpi_classify_FTTRI", "mpi_classify_CLTomo_prog",
               "mpi_performance_test", "mpi_write_test"]
DESCR = """# Phantom description file
   24 24 24 0.1 1
sph + 1.0 3 -2 1 4
blo + 0.8 -6 4 -3 5 10.4 2
cyl + 0.7 5 -5 0 2 3 8 30 40 10
ell = 1.2 -3 0 6 3 2 4 45 20 10
"""


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


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    d = tmp_path_factory.mktemp("flex_tail")
    for t in "jt":
        (d / t).mkdir()
    return d


@pytest.fixture(scope="module")
def views(d):
    """40 views at 32^2 of two states of the 8-blob phantom, each at a
    random in-plane angle and shift with noise, and the true states."""
    from xmipp3_tpu_torch.ops.project import FourierProjector
    rng = np.random.default_rng(8)
    n, B = 32, 40
    state = np.arange(B) % 2
    imgs = np.empty((B, n, n), np.float32)
    for s in (0, 1):
        v = phantom8(n) if s == 0 else phantom8(n, scale=n / 30)
        sel = np.flatnonzero(state == s)
        imgs[sel] = FourierProjector(v, device="cpu").project_euler(
            np.full(len(sel), 20.0 + 40.0 * s, np.float32),
            np.full(len(sel), 50.0, np.float32),
            rng.uniform(0, 360, len(sel)).astype(np.float32),
            shifts=rng.uniform(-2, 2, (len(sel), 2)).astype(np.float32)
        ).numpy()
    imgs += 0.05 * imgs.std() * rng.standard_normal(imgs.shape
                                                    ).astype(np.float32)
    save_image(str(d / "views.mrcs"), imgs)
    MetaData.fromRows({"image": f"{i + 1:06d}@{d / 'views.mrcs'}",
                       "itemId": i + 1} for i in range(B)
                      ).write(str(d / "views.xmd"))
    return d, state


FTTRI = ["--nref", 2, "--padding", 2, "--pca", 5, "--nmin", 3, "--iter", 3]


def test_classify_fttri_matches_the_reference(views):
    d, state = views
    (pj, pt), _ = both("classify_FTTRI", lambda t: [
        "-i", d / "views.xmd", "--oroot", d / t / "ft", *FTTRI, "--mesh",
        "none"])
    np.testing.assert_array_equal(pt.labels, pj.labels)
    assert rel(stack(d / "t" / "ft_FTTRI.mrcs"),
               stack(d / "j" / "ft_FTTRI.mrcs")) <= 1e-4
    assert np.array_equal(vol(d / "t" / "ft_mask.mrc"),
                          vol(d / "j" / "ft_mask.mrc"))
    assert [r["ref"] for r in rows(d / "t" / "ft_classes.xmd")] == \
        [r["ref"] for r in rows(d / "j" / "ft_classes.xmd")]
    # the features separate the two states
    purity = max(np.mean(pt.labels == state), np.mean(pt.labels != state))
    assert purity >= 0.9
    (pj, pt), _ = both("mpi_classify_FTTRI", lambda t: [
        "-i", d / "views.xmd", "--oroot", d / t / "ftp", "-o",
        d / t / "ftp.xmd", "--nref", 3, "--zoom", 2.8, "--maxfreq", -1,
        "--doPhase", "--mesh", "none"])
    np.testing.assert_array_equal(pt.labels, pj.labels)


def test_classify_fttri_mesh_dp_equals_serial(views, tmp_path):
    """--mesh dp over 2 gloo ranks: each rank takes its rows of every
    chunk of 128 images (64 a rank; here one chunk of 40 padded to 40),
    and the features meet in one all_gather."""
    from test_torch_common import Ranks
    d, _ = views
    argv = lambda root: ["-i", str(d / "views.xmd"), "--oroot", str(root),
                         *map(str, FTTRI)]
    with redirect_stdout(io.StringIO()):
        assert get_program("classify_FTTRI").run_with_args(
            argv(tmp_path / "serial") + ["--device", "cpu", "-v", "0"]) == 0
    ranks = Ranks(2, [{"name": "dp", "program": "classify_FTTRI",
                       "argv": argv(tmp_path / "mesh") + ["--mesh", "dp"]}],
                  tmp_path, {})
    for rep in ranks.join():
        assert rep["jobs"]["dp"]["rc"] == 0, rep
    assert [r["ref"] for r in rows(tmp_path / "mesh_classes.xmd")] == \
        [r["ref"] for r in rows(tmp_path / "serial_classes.xmd")]
    assert np.array_equal(stack(tmp_path / "mesh_FTTRI.mrcs"),
                          stack(tmp_path / "serial_FTTRI.mrcs"))


def test_classify_cltomo_matches_the_reference(d):
    n, B = 16, 12
    rng = np.random.default_rng(9)
    f = np.fft.fftfreq(n)
    fz, _, fx = np.meshgrid(f, f, f, indexing="ij")
    wedge = np.abs(fz) <= np.abs(fx) * np.tan(np.deg2rad(60)) + 1e-9
    states = [phantom8(n), phantom8(n, scale=n / 36)]
    for i in range(B):
        v = np.roll(states[i % 2], tuple(rng.integers(-1, 2, 3)), (0, 1, 2))
        v = np.fft.ifftn(np.fft.fftn(v) * wedge).real
        v += 0.05 * rng.standard_normal(v.shape)
        save_image(str(d / f"sub{i}.vol"), v.astype(np.float32))
    MetaData.fromRows({"image": str(d / f"sub{i}.vol"), "itemId": i + 1}
                      for i in range(B)).write(str(d / "subs.xmd"))
    for name, extra in (("classify_CLTomo_prog", []),
                        ("mpi_classify_CLTomo_prog",
                         ["--nref", 3, "--maxTilt", 50, "--maxFreq", 0.3,
                          "--iter", 4])):
        (pj, pt), _ = both(name, lambda t: [
            "-i", d / "subs.xmd", "-o", d / t / "cl.xmd", "--oroot",
            d / t / "cls", *extra])
        np.testing.assert_array_equal(pt.labels, pj.labels)
        assert [r["ref"] for r in rows(d / "t" / "cl.xmd")] == \
            [r["ref"] for r in rows(d / "j" / "cl.xmd")]
        for c in np.unique(pj.labels):
            fn = f"cls{c + 1:03d}.vol"
            assert rel(vol(d / "t" / fn), vol(d / "j" / fn)) <= 1e-6
        if name == "classify_CLTomo_prog":        # the two states split
            assert len(set(pt.labels[0::2])) == len(set(pt.labels[1::2])) \
                == 1 and pt.labels[0] != pt.labels[1]


@pytest.fixture(scope="module")
def anneal_views(d):
    from xmipp3_tpu_torch.ops.project import FourierProjector
    rng = np.random.default_rng(12)
    n, B = 24, 16
    rot, psi = rng.uniform(0, 360, (2, B)).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, B))).astype(np.float32)
    imgs = FourierProjector(phantom8(n), device="cpu").project_euler(
        rot, tilt, psi).numpy()
    save_image(str(d / "anneal.mrcs"), imgs)
    MetaData.fromRows({"image": f"{i + 1:06d}@{d / 'anneal.mrcs'}",
                       "itemId": i + 1} for i in range(B)
                      ).write(str(d / "anneal.xmd"))
    return d


def test_annealing_matches_the_reference(anneal_views):
    """One random and one greedy round. The random round's draws and
    Metropolis choices are the same, so its map grids the same poses (K3's
    plain version against the reference's window: 5e-3); the greedy
    round's poses within one gallery step for >= 90 % of the views, the
    final maps correlated >= 0.99."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    d = anneal_views
    both("volume_initial_simulated_annealing", lambda t: [
        "-i", d / "anneal.xmd", "--oroot", d / t / "sa", "--randomIter", 1,
        "--greedyIter", 1, "--angSampling", 30, "--dontApplyPositive",
        "--rejection", 0, "--keepIntermediateVolumes"])
    assert rel(vol(d / "t" / "sa_random01.vol"),
               vol(d / "j" / "sa_random01.vol")) <= 5e-3
    a, b = rows(d / "t" / "sa.xmd"), rows(d / "j" / "sa.xmd")
    ang = lambda rs: np.asarray(euler_matrix(
        *(np.array([r[k] for r in rs]) for k in
          ("angleRot", "angleTilt", "anglePsi"))), np.float64)
    cos = (np.einsum("nij,nij->n", ang(a), ang(b)) - 1) / 2
    within = np.degrees(np.arccos(np.clip(cos, -1, 1))) <= 30.0
    assert within.mean() >= 0.9
    va, vb = vol(d / "t" / "sa.vol"), vol(d / "j" / "sa.vol")
    va, vb = va - va.mean(), vb - vb.mean()
    assert (va * vb).sum() / np.sqrt((va * va).sum() * (vb * vb).sum()) \
        >= 0.99


def test_annealing_refuses_sym(anneal_views):
    """ROADMAP.md section 3, item 24: the reference never reads --sym."""
    d = anneal_views
    err = io.StringIO()
    with redirect_stderr(err):
        assert get_program("volume_initial_simulated_annealing"
                           ).run_with_args([
                               "-i", str(d / "anneal.xmd"), "--oroot",
                               str(d / "t" / "x"), "--sym", "c4",
                               "--device", "cpu", "-v", "0"]) == 1
    assert "item 24" in err.getvalue()


@pytest.mark.parametrize("op", [["shift", 1.5, -2, 3], ["scale", 1.2, 1.2,
                                                          1.2],
                                ["rotate_euler", 30, 20, 10]])
def test_phantom_transform_matches_the_reference(d, op):
    (d / "ph.descr").write_text(DESCR)
    lines = []
    rng = np.random.default_rng(3)
    for i in range(12):
        x, y, z = rng.normal(0, 6, 3)
        lines.append(f"ATOM  {i + 1:5d}  CA  ALA A{i + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00{10 + i:6.2f}"
                     f"           C\n")
    (d / "m.pdb").write_text("REMARK test\n" + "".join(lines) + "END\n")
    for src, extra in (("ph.descr", []), ("m.pdb", []),
                       ("m.pdb", ["--center_pdb"])):
        ext = src.split(".")[1]
        both("phantom_transform", lambda t: [
            "-i", d / src, "-o", d / t / f"out.{ext}", "--operation", *op,
            *extra])
        assert (d / "t" / f"out.{ext}").read_text() == \
            (d / "j" / f"out.{ext}").read_text()


def test_volume_to_web_matches_the_reference(d):
    save_image(str(d / "web.vol"), phantom8(24))
    for n in (-1, 5):
        both("volume_to_web", lambda t: [
            "-i", d / "web.vol", "--central_slices", d / t / "sl.xmp", n,
            "--projections", d / t / "pr.xmp", "--maxWidth", 80,
            "--separation", 3])
        assert np.array_equal(vol(d / "t" / "sl.xmp"), vol(d / "j" / "sl.xmp"))
        assert rel(vol(d / "t" / "pr.xmp"), vol(d / "j" / "pr.xmp")) <= 1e-6


def test_resolution_pdb_bfactor_matches_the_reference(d):
    rng = np.random.default_rng(4)
    save_image(str(d / "locres.vol"),
               rng.uniform(2, 8, (24, 24, 24)).astype(np.float32))
    lines = []
    for i in range(30):
        x, y, z = rng.uniform(-10, 10, 3)
        for name in ("N", "CA", "C"):
            lines.append(f"ATOM  {3 * i:5d}  {name:<3s} ALA {'AB'[i % 2]}"
                         f"{i // 2 + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}"
                         f"  1.00{rng.uniform(10, 90):6.2f}           C\n")
    (d / "bf.pdb").write_text("".join(lines))
    for extra in ([], ["--useMedian", "--fscResolution", 4.0]):
        (pj, pt), _ = both("resolution_pdb_bfactor", lambda t: [
            "--atmodel", d / "bf.pdb", "--vol", d / "locres.vol", "-o",
            d / t / "bf.xmd", "--centered", "--sampling", 1.2, *extra])
        assert (d / "t" / "bf.xmd").read_text() == \
            (d / "j" / "bf.xmd").read_text()
        assert pt.correlation == pj.correlation


def test_performance_and_write_tests(d):
    MetaData.fromRows({"image": f"{i}@x.mrcs"} for i in range(5)
                      ).write(str(d / "sel.xmd"))
    for name in ("performance_test", "mpi_performance_test"):
        prog = get_program(name)
        with redirect_stdout(io.StringIO()) as out:
            assert prog.run_with_args([
                "-i", str(d / "sel.xmd"), "--size", "32", "--batch", "4",
                "--device", "cpu", "-v", "0"]) == 0
        assert "metadata read: 5 rows" in out.getvalue()
        assert all(np.isfinite(v) and v > 0 for v in prog.results.values())
    for name in ("write_test", "mpi_write_test"):
        prog = get_program(name)
        fn = d / "t" / "wt.mrcs"
        with redirect_stdout(io.StringIO()):
            assert prog.run_with_args(["--size", "1", "-o", str(fn),
                                       "-v", "0"]) == 0
        assert prog.mb_per_s > 0 and not fn.exists()


@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_new_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_the_registry_holds_218_endpoints():
    from xmipp3_tpu_torch.programs import list_programs
    import test_torch_cli_tail as tail
    import test_torch_cli_tomo as tomo
    names = set(list_programs())
    new = set(NEW) | set(tomo.NEW)
    aliases = set(NEW_ALIASES) | set(tomo.NEW_ALIASES)
    assert len(new) == 28 and len(aliases) == 5
    assert new | aliases <= names
    # the endpoints of the later slice (tests/test_torch_cli_tail.py) aside
    later = set(tail.NEW) | set(tail.NEW_ALIASES)
    assert len(names - later) == 218 and len(set(ALIASES) - later) == 59
