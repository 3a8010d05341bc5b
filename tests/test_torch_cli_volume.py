"""The volume programs (volume_programs) against the reference package's
on the same files, on the CPU (the 8-blob phantom at N=32, a 60-atom
model, 2-D views at 32²), the port with --device cpu; the reference's 2
aliases of them, its grammar, the flags it declares and never reads,
which the port refuses; and the registry's 161 endpoints.

Tolerances, relative to the max of the reference's output where not said:
- volume_from_pdb: equal in the splatting modes (the same host numpy);
  with --high_sampling_rate 1e-5 (the Fourier downscaling, float32 FFTs);
- volume_center: the shift equal (host numpy), the volume 1e-5 (a phase
  ramp, float32 FFTs);
- volume_align: the grid's fits 1e-3 (read 2.4e-4: on the same warp,
  which agrees to 6e-7, the reference's float32 sums over the 32^3
  voxels land 4e-4 off a float64 fitness, the port's 3e-9) and the same
  winning trial (so the sphere search at --step 60); --local the same Powell end within 0.05
  of each parameter (scipy's Powell on float32 fits that agree to 1e-6);
  --frm the same rotation matrix within 0.5 degrees and its translation
  column within 0.05 px (the same integer shift turned by the two
  rotations; the SO(3) grid and its polish on the same input,
  tests/test_torch_frm_helical.py); the --apply volume 1e-4; the
  --copyGeo matrix 1e-6 absolute;
- volume_subtraction: 1e-4 (tests/test_torch_pocs.py holds the loop),
  5e-3 for the direct amplitudes after a low-pass cut (read 3.2e-3; the
  roundoff that loop amplifies, tests/test_torch_pocs.py);
- volume_segment: equal (host numpy);
- transform_mask: 1e-6 (float32 products; the masks are the same host
  numpy); --create_mask and the counts equal;
- transform_symmetrize: the volumes equal (scipy on the host in both);
  the 2-D images 1e-5 (the rotations on the port's device, summed in
  float64);
- volume_to_pseudoatoms: the same iterations, atom count and final error
  to 1e-3 relative, and the PDB's coordinates within 0.01 A (50 float32
  gradient steps a block, the same host seeding and removal).
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_cli_analysis import both, rel, vol
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

N = 32
NEW = ["volume_from_pdb", "volume_center", "volume_align",
       "volume_subtraction", "volume_segment", "transform_mask",
       "transform_symmetrize", "volume_to_pseudoatoms"]
NEW_ALIASES = ["mpi_transform_mask", "mpi_transform_symmetrize"]


def write_model(path, n_atoms=60, seed=3):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 5.0, (n_atoms, 3))
    els = rng.choice(["C", "N", "O", "S"], n_atoms, p=[.6, .2, .15, .05])
    with open(path, "w") as f:
        for i, ((x, y, z), el) in enumerate(zip(xyz, els)):
            rec = "HETATM" if i % 17 == 5 else "ATOM  "
            f.write(f"{rec}{i + 1:5d}  {el:<3s} ALA A{i + 1:4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}"
                    f"{rng.uniform(5, 30):6.2f}          {el:>2s}\n")
        f.write("END\n")


def c4(v):
    """The C4 average of v about its z axis (numpy rotations of the
    (y, x) planes by 90 degrees)."""
    return sum(np.rot90(v, k, axes=(1, 2)) for k in range(4)) / 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("volume")
    for t in "jt":
        (d / t).mkdir()
    rng = np.random.default_rng(9)
    v = phantom8(N)
    save_image(str(d / "vol.vol"), v)
    save_image(str(d / "shifted.vol"), np.roll(v, (2, -1, 3), (0, 1, 2)))
    # a 20-degree turn about z and a (1, -2, 0) voxel shift: the grid of
    # volume_align holds it exactly
    from scipy.ndimage import rotate
    moved = rotate(v, 20.0, axes=(2, 1), reshape=False, order=1)
    save_image(str(d / "moved.vol"), np.roll(moved, (0, -2, 1), (0, 1, 2)))
    sub = phantom8(N) - 0.0
    save_image(str(d / "noisy.vol"),
               1.2 * sub + 0.05 * rng.standard_normal(sub.shape)
               .astype(np.float32))
    zz, yy, xx = np.mgrid[:N, :N, :N] - N // 2
    sphere = ((zz ** 2 + yy ** 2 + xx ** 2) < 13 ** 2).astype(np.float32)
    save_image(str(d / "sphere.vol"), sphere)
    sym = c4(v)
    save_image(str(d / "c4_noisy.vol"),
               sym + 0.1 * rng.standard_normal(sym.shape).astype(
                   np.float32))
    imgs = np.stack([v.sum(axis=k) for k in range(3)] * 2).astype(
        np.float32)
    imgs += 0.05 * rng.standard_normal(imgs.shape).astype(np.float32)
    save_image(str(d / "imgs.mrcs"), imgs)
    write_model(str(d / "model.pdb"))
    return d


# -- volume_from_pdb -----------------------------------------------------

@pytest.mark.parametrize("flags,tol", [
    ([], 0.0), (["--blobs"], 0.0), (["--poor_Gaussian", "--noHet"], 0.0),
    (["--fixed_Gaussian", "1.5", "--centerPDB"], 0.0),
    (["--fixed_Gaussian", "-1", "--intensityColumn", "Bfactor"], 0.0),
    (["--size", "40", "--orig", "1", "2", "0"], 0.0),
    (["--high_sampling_rate", "1", "--sampling", "2", "--size", "24"],
     1e-5)])
def test_volume_from_pdb_matches_the_reference(data, flags, tol):
    d = data
    tag = "_".join(f.strip("-") for f in flags) or "plain"
    both("volume_from_pdb", lambda t: [
        "-i", str(d / "model.pdb"), "-o", str(d / t / f"pdb_{tag}")] + flags)
    got, want = vol(d / "t" / f"pdb_{tag}.vol"), \
        vol(d / "j" / f"pdb_{tag}.vol")
    assert got.shape == want.shape
    assert rel(got, want) <= tol


# -- volume_center ---------------------------------------------------------

def test_volume_center_matches_the_reference(data):
    d = data
    j, t = both("volume_center", lambda t: [
        "-i", str(d / "shifted.vol"), "-o", str(d / t / "centered.vol")])
    np.testing.assert_array_equal(np.float64(t.shift), np.float64(j.shift))
    assert rel(vol(d / "t" / "centered.vol"),
               vol(d / "j" / "centered.vol")) <= 1e-5


# -- volume_align ----------------------------------------------------------

def test_volume_align_grid_matches_the_reference(data, capsys):
    d = data
    args = lambda t: [
        "--i1", str(d / "vol.vol"), "--i2", str(d / "moved.vol"),
        "--rot", "-30", "0", "10", "--tilt", "0", "10", "10",
        "-y", "-2", "2", "1", "-x", "-1", "1", "1", "--consider_mirror",
        "--apply", str(d / t / "aligned.vol"),
        "--copyGeo", str(d / t / "geo.txt"), "--store", str(d / t / "s.txt")]
    j, t = both("volume_align", args)
    assert t.angles == j.angles
    assert t.fit == pytest.approx(j.fit, rel=1e-3)
    np.testing.assert_allclose(np.loadtxt(d / "t" / "geo.txt"),
                               np.loadtxt(d / "j" / "geo.txt"), atol=1e-6)
    assert rel(vol(d / "t" / "aligned.vol"),
               vol(d / "j" / "aligned.vol")) <= 1e-4
    # every trial's fit, through --show_fit
    outs = []
    for get, tail in ((jax_program, []), (get_program, ["--device", "cpu"])):
        with redirect_stdout(io.StringIO()) as buf:
            assert get("volume_align").run_with_args(
                args("j")[:-6] + ["--show_fit", "-v", "0"] + tail) == 0
        outs.append(np.array([[float(x) for x in ln.split()]
                              for ln in buf.getvalue().splitlines()
                              if ln and ln[0] in "-0123456789"]))
    assert outs[0].shape == outs[1].shape and len(outs[0]) == 2 * 4 * 2 * 5 * 3
    np.testing.assert_array_equal(outs[1][:, :-1], outs[0][:, :-1])
    assert rel(outs[1][:, -1], outs[0][:, -1]) <= 1e-3


def test_volume_align_sphere_search_matches_the_reference(data):
    d = data
    j, t = both("volume_align", lambda t: [
        "--i1", str(d / "vol.vol"), "--i2", str(d / "moved.vol"),
        "--step", "60", "--least_squares"])
    assert t.angles == j.angles
    assert t.fit == pytest.approx(j.fit, rel=1e-3)


def test_volume_align_local_and_frm_match_the_reference(data):
    d = data
    j, t = both("volume_align", lambda t: [
        "--i1", str(d / "vol.vol"), "--i2", str(d / "moved.vol"),
        "--rot", "-15", "--local", "--onlyShift"])
    np.testing.assert_allclose(t.matrix_A, j.matrix_A, atol=0.05)
    j, t = both("volume_align", lambda t: [
        "--i1", str(d / "vol.vol"), "--i2", str(d / "moved.vol"),
        "--frm", "0.25", "4"])
    np.testing.assert_allclose(t.matrix_A[:3, 3], j.matrix_A[:3, 3],
                               atol=0.05)
    np.testing.assert_allclose(t.matrix_A[:3, :3], j.matrix_A[:3, :3],
                               atol=np.deg2rad(0.5))


# -- volume_subtraction ------------------------------------------------------

@pytest.mark.parametrize("flags", [
    [], ["--radavg"], ["--sub", "--radavg", "--sigma", "2"],
    ["--sub", "--cutFreq", "0.3", "--lambda", "0.8", "--iter", "3"]])
def test_volume_subtraction_matches_the_reference(data, flags):
    d = data
    tag = "_".join(f.strip("-") for f in flags) or "plain"
    extra = lambda t: (["--saveV1", str(d / t / f"v1_{tag}.vol"),
                        "--saveV2", str(d / t / f"v2_{tag}.vol"),
                        "--mask1", str(d / "sphere.vol"),
                        "--mask2", str(d / "sphere.vol")]
                       if "--sub" in flags else [])
    both("volume_subtraction", lambda t: [
        "--i1", str(d / "vol.vol"), "--i2", str(d / "noisy.vol"),
        "-o", str(d / t / f"sub_{tag}.vol")] + flags + extra(t))
    outs = [f"sub_{tag}.vol"] + ([f"v1_{tag}.vol", f"v2_{tag}.vol"]
                                 if "--sub" in flags else [])
    for name in outs:
        tol = 5e-3 if "--cutFreq" in flags and "--radavg" not in flags \
            else 1e-4
        assert rel(vol(d / "t" / name), vol(d / "j" / name)) <= tol, name


# -- volume_segment ----------------------------------------------------------

@pytest.mark.parametrize("method", [[], ["threshold", "0.3"],
                                    ["voxel_mass", "900"], ["otsu"]])
def test_volume_segment_matches_the_reference(data, method):
    d = data
    tag = method[0] if method else "default"
    j, t = both("volume_segment", lambda t: [
        "-i", str(d / "noisy.vol"), "-o", str(d / t / f"seg_{tag}.vol")]
        + (["--method"] + method if method else []))
    assert t.threshold == j.threshold
    np.testing.assert_array_equal(vol(d / "t" / f"seg_{tag}.vol"),
                                  vol(d / "j" / f"seg_{tag}.vol"))


# -- transform_mask ------------------------------------------------------------

@pytest.mark.parametrize("mask,sub", [
    (["circular", "-10"], "0"), (["crown", "4", "12"], "avg"),
    (["gaussian", "5"], "0.5"), (["rectangular", "6", "8", "4"], "min"),
    (["blob_circular", "10", "3"], "max"), (["blob_crown", "5", "12", "-2"],
                                             "0"),
    (["binary_file", "SPHERE"], "avg")])
@pytest.mark.parametrize("what", ["vol", "imgs"])
def test_transform_mask_matches_the_reference(data, mask, sub, what):
    d = data
    mask = [str(d / "sphere.vol") if m == "SPHERE" else m for m in mask]
    if what == "imgs" and mask[0] == "binary_file":
        return
    src = "vol.vol" if what == "vol" else "imgs.mrcs"
    ext = ".vol" if what == "vol" else ".mrcs"
    tag = f"{mask[0]}_{what}"
    both("transform_mask", lambda t: [
        "-i", str(d / src), "-o", str(d / t / f"m_{tag}{ext}"),
        "--mask"] + mask + ["--substitute", sub])
    assert rel(vol(d / "t" / f"m_{tag}{ext}"),
               vol(d / "j" / f"m_{tag}{ext}")) <= 1e-6


def test_transform_mask_create_and_count(data, capsys):
    d = data
    both("transform_mask", lambda t: [
        "-i", str(d / "vol.vol"), "--mask", "circular", "9",
        "--create_mask", str(d / t / "made.vol")])
    np.testing.assert_array_equal(vol(d / "t" / "made.vol"),
                                  vol(d / "j" / "made.vol"))
    capsys.readouterr()
    outs = []
    for get, tail in ((jax_program, []), (get_program, ["--device", "cpu"])):
        prog = get("transform_mask")
        assert prog.run_with_args(
            ["-i", str(d / "imgs.mrcs"), "--mask", "circular", "12",
             "--count_above", "0.5", "--count_below", "20", "-o",
             str(d / "counts.xmd")] + tail) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "above 0.5 and below 20" in outs[1]


# -- transform_symmetrize --------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--sym", "c4"], ["--sym", "c4", "--dont_wrap", "--spline", "1"],
    ["--sym", "d2", "--sum", "--mask_in", "SPHERE"],
    ["--sym", "helical", "--helixParams", "4", "30", "--sampling", "1"],
    ["--sym", "dihedral"]])
def test_transform_symmetrize_volume_matches_the_reference(data, flags):
    d = data
    flags = [str(d / "sphere.vol") if f == "SPHERE" else f for f in flags]
    tag = "_".join(f.strip("-") for f in flags[:3]).replace("/", "")[:40]
    both("transform_symmetrize", lambda t: [
        "-i", str(d / "c4_noisy.vol"), "-o", str(d / t / f"s_{tag}.vol")]
        + flags)
    np.testing.assert_array_equal(vol(d / "t" / f"s_{tag}.vol"),
                                  vol(d / "j" / f"s_{tag}.vol"))


@pytest.mark.parametrize("flags", [["--sym", "5"], ["--sym", "3", "--sum"]])
def test_transform_symmetrize_images_matches_the_reference(data, flags):
    d = data
    tag = "_".join(f.strip("-") for f in flags)
    both("transform_symmetrize", lambda t: [
        "-i", str(d / "imgs.mrcs"), "-o", str(d / t / f"s_{tag}.mrcs")]
        + flags)
    assert rel(vol(d / "t" / f"s_{tag}.mrcs"),
               vol(d / "j" / f"s_{tag}.mrcs")) <= 1e-5


def test_symmetrized_c4_is_closer_to_the_clean_map(data):
    d = data
    both("transform_symmetrize", lambda t: [
        "-i", str(d / "c4_noisy.vol"), "-o", str(d / t / "c4.vol"),
        "--sym", "c4"])
    clean = c4(phantom8(N))
    err = lambda v: float(np.abs(v - clean).mean())
    assert err(vol(d / "t" / "c4.vol")) < 0.6 * err(vol(d / "c4_noisy.vol"))


# -- volume_to_pseudoatoms --------------------------------------------------

def read_atoms(path):
    return np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                     for ln in open(path) if ln.startswith("ATOM")])


def test_volume_to_pseudoatoms_matches_the_reference(data):
    d = data
    j, t = both("volume_to_pseudoatoms", lambda t: [
        "-i", str(d / "vol.vol"), "-o", str(d / t / "atoms"),
        "--sigma", "2", "--initialSeeds", "40", "--targetError", "8",
        "--growSeeds", "40"])
    assert t.n_placed == j.n_placed
    assert t.final_error == pytest.approx(j.final_error, rel=1e-3)
    assert t.final_error <= 0.08
    got, want = read_atoms(d / "t" / "atoms.pdb"), \
        read_atoms(d / "j" / "atoms.pdb")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.01)


# -- grammar, aliases, refused flags, the registry -------------------------

@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_the_registry_holds_161_endpoints():
    import test_torch_cli_flex as flex
    import test_torch_cli_flex_tail as flex_tail
    import test_torch_cli_micrograph as micrograph
    import test_torch_cli_misc as misc
    import test_torch_cli_tail as tail
    import test_torch_cli_tomo as tomo
    from xmipp3_tpu_torch.programs import list_programs
    names = set(list_programs())
    new = set(NEW) | set(micrograph.NEW) | set(misc.NEW)
    aliases = set(NEW_ALIASES) | set(misc.NEW_ALIASES)
    assert len(new) == 18 and len(aliases) == 3
    assert new | aliases <= names
    # the endpoints of the later slices (tests/test_torch_cli_flex.py,
    # tests/test_torch_cli_flex_tail.py, tests/test_torch_cli_tomo.py,
    # tests/test_torch_cli_tail.py) aside
    later = set().union(*(set(m.NEW) | set(m.NEW_ALIASES)
                          for m in (flex, flex_tail, tomo, tail)))
    assert len(names - later) == 161 and len(set(ALIASES) - later) == 46


REFUSED = {
    "volume_subtraction": (["--i1", "V", "--i2", "V", "-o", "O",
                            "--computeEnergy"], "--computeEnergy"),
    "transform_symmetrize": (["-i", "V", "-o", "O", "--sym", "c4",
                              "--no_group"], "--no_group"),
    "volume_align": (["--i1", "V", "--i2", "V", "--frm", "0.25", "10",
                      "-45", "90"], "--frm"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_flags_the_reference_never_reads_are_refused(data, tmp_path, name,
                                                      capsys):
    args, flag = REFUSED[name]
    sub = {"V": str(data / "vol.vol"), "O": str(tmp_path / "out.vol")}
    assert get_program(name).run_with_args(
        [sub.get(a, a) for a in args] + ["--device", "cpu", "-v", "0"]) == 1
    err = capsys.readouterr().err
    assert flag in err and "never reads" in err
    assert not list(tmp_path.iterdir())
