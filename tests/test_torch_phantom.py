"""Phantoms, atomic models and projection of the port against the reference
package's, on the CPU (N=32): ops/phantom.py (Phantom, Feature, voxelize),
core/pdb.py (readers, writers, rasterization), ops/project.py::
project_real_space, and the programs phantom_create, phantom_project (and
its `project` alias) and phantom_simulate_microscope, each package on the
same files.

Tolerances, relative to the max of the reference's output:
- voxelize: equal, bit for bit (float64 coordinates in both, every
  feature type, + and =, with and without a scale);
- atomic models: the parsed fields equal; rasterize_modes 1e-6 (host numpy
  in both), 1e-5 through the Fourier downscaling of --high_sampling_rate;
- project_real_space: 1e-5 (the same trilinear warp in float32), chunked
  views equal to one batch bit for bit;
- phantom_project: the angles of --nangles equal bit for bit (numpy's
  Generator in both); Fourier projections 1e-5, real-space ones 1e-5;
- phantom_simulate_microscope: 1e-5 (the same numpy noise; the CTF in
  float32 on both sides, the noise filter float64 in the reference).
"""
import numpy as np
import pytest
import torch

from xmipp3_tpu.core import pdb as jpdb
from xmipp3_tpu.ops.phantom import Phantom as JPhantom
from xmipp3_tpu.ops.project import project_real_space as jax_prs
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core import pdb as tpdb
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.ctf import CTFDescription
from xmipp3_tpu_torch.ops.phantom import Phantom
from xmipp3_tpu_torch.ops.project import project_real_space
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)

N = 32
DESCR = f"""# Phantom description file
   {N} {N} {N} 0.1 1
sph + 1.0 3 -2 1 4
blo + 0.8 -6 4 -3 5 10.4 2
gau + 0.5 0 0 0 3
cyl + 0.7 5 -5 0 2 3 8 30 40 10
dcy = 0.9 -5 -5 5 2 3 2 10 60 0
cub + 0.6 0 6 -6 4 5 3 0 30 60
ell = 1.2 -3 0 6 3 2 4 45 20 10
con + 0.4 6 6 6 3 6 15 75 20
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("phantom")
    for t in "jt":
        (d / t).mkdir()
    (d / "ph.descr").write_text(DESCR)
    rng = np.random.default_rng(17)
    n_atoms = 240
    els = list(rng.choice(["C", "N", "O", "S", "P", "H", "FE"], n_atoms))
    model = tpdb.AtomicModel(rng.normal(0, 6.0, (n_atoms, 3)) + 20.0, els,
                             rng.uniform(0.5, 2.5, n_atoms).astype(np.float32),
                             rng.uniform(0.5, 1.0, n_atoms).astype(np.float32))
    tpdb.write_pdb(str(d / "model.pdb"), model)
    return d


def both(name, args_of):
    for tag, get in (("j", jax_program), ("t", get_program)):
        tail = ["-v", "0"] + (["--device", "cpu"] if tag == "t" else [])
        assert get(name).run_with_args(args_of(tag) + tail) == 0, tag


def vol(path):
    return np.squeeze(Image(str(path)).data)


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_descr_reads_and_writes_as_the_reference(files, tmp_path):
    ph, jph = Phantom.read(str(files / "ph.descr")), \
        JPhantom.read(str(files / "ph.descr"))
    assert (ph.dims, ph.background, ph.scale) == \
        (jph.dims, jph.background, jph.scale)
    assert [(f.ftype, f.add_assign, f.density, list(f.center), f.params)
            for f in ph.features] == \
        [(f.ftype, f.add_assign, f.density, list(f.center), f.params)
         for f in jph.features]
    ph.write(str(tmp_path / "t.descr"))
    jph.write(str(tmp_path / "j.descr"))
    assert (tmp_path / "t.descr").read_text() == \
        (tmp_path / "j.descr").read_text()


@pytest.mark.parametrize("scale", [1.0, 1.3])
def test_voxelize_matches_the_reference(files, scale):
    ph = Phantom.read(str(files / "ph.descr"))
    jph = JPhantom.read(str(files / "ph.descr"))
    ph.scale = jph.scale = scale
    got = ph.voxelize("cpu").numpy()
    want = jph.voxelize()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _model(files, which):
    return which.read_pdb(str(files / "model.pdb"))


def test_pdb_reader_and_writers_match_the_reference(files, tmp_path):
    m, jm = _model(files, tpdb), _model(files, jpdb)
    np.testing.assert_array_equal(m.coords, jm.coords)
    assert m.elements == jm.elements
    np.testing.assert_array_equal(m.weights, jm.weights)
    np.testing.assert_array_equal(m.radii, jm.radii)
    np.testing.assert_array_equal(m.het, jm.het)
    tpdb.write_pdb(str(tmp_path / "t.pdb"), m)
    jpdb.write_pdb(str(tmp_path / "j.pdb"), jm)
    assert (tmp_path / "t.pdb").read_text() == \
        (tmp_path / "j.pdb").read_text()
    atoms = [tpdb.RichAtom(serial=i + 1, name=e + "A", resname="ALA",
                           altloc="A", resseq=i // 4 + 1, seq_id=1,
                           x=float(c[0]), y=float(c[1]), z=float(c[2]),
                           occupancy=float(o), bfactor=float(b),
                           auth_seq_id=i // 4 + 1, auth_comp_id="ALA",
                           auth_asym_id="A", auth_atom_id=e + "A")
             for i, (e, c, o, b) in enumerate(zip(
                 m.elements[:20], m.coords, m.occupancies, m.bfactors))]
    tpdb.write_rich_cif(str(tmp_path / "t.cif"), atoms)
    jpdb.write_rich_cif(str(tmp_path / "j.cif"),
                        [jpdb.RichAtom(**vars(a)) for a in atoms])
    assert (tmp_path / "t.cif").read_text() == \
        (tmp_path / "j.cif").read_text()
    assert [vars(a) for a in tpdb.read_rich_cif(str(tmp_path / "t.cif"))] \
        == [vars(a) for a in jpdb.read_rich_cif(str(tmp_path / "t.cif"))]
    c, jc = tpdb.read_pdb(str(tmp_path / "t.cif")), \
        jpdb.read_pdb(str(tmp_path / "t.cif"))
    np.testing.assert_array_equal(c.coords, jc.coords)
    assert c.elements == jc.elements


@pytest.mark.parametrize("mode", ["scattering", "blobs", "poor_gaussian",
                                  "fixed_gaussian"])
def test_rasterize_modes_matches_the_reference(files, mode):
    m, jm = _model(files, tpdb).centered(), _model(files, jpdb).centered()
    got = tpdb.rasterize_modes(m, (N, N, N), 2.0, mode, device="cpu")
    want = jpdb.rasterize_modes(jm, (N, N, N), 2.0, mode)
    assert rel(got, want) <= 1e-6


def test_rasterize_through_the_fourier_downscaling_and_plain(files):
    m, jm = _model(files, tpdb).centered(), _model(files, jpdb).centered()
    got = tpdb.rasterize_modes(m, (24, 24, 24), 2.0, high_sampling=1.0,
                               device="cpu")
    want = jpdb.rasterize_modes(jm, (24, 24, 24), 2.0, high_sampling=1.0)
    assert got.shape == (24, 24, 24) and rel(got, want) <= 1e-5
    assert rel(tpdb.rasterize(m, N, 2.0), jpdb.rasterize(jm, N, 2.0)) <= 1e-6


def test_project_real_space_matches_the_reference_and_chunks(files):
    v = Phantom.read(str(files / "ph.descr")).voxelize("cpu")
    rng = np.random.default_rng(3)
    rot, psi = rng.uniform(-180, 180, (2, 7)).astype(np.float32)
    tilt = rng.uniform(0, 180, 7).astype(np.float32)
    got = project_real_space(v, rot, tilt, psi)
    want = np.asarray(jax_prs(v.numpy(), rot, tilt, psi))
    assert got.shape == (7, N, N) and rel(got.numpy(), want) <= 1e-5
    parts = project_real_space(v, rot, tilt, psi,
                               chunk_bytes=2 * 4 * v.numel())
    np.testing.assert_array_equal(parts.numpy(), got.numpy())


def test_phantom_create_matches_the_reference(files):
    d = files
    both("phantom_create", lambda t: ["-i", str(d / "ph.descr"), "-o",
                                      str(d / t / "ph.vol")])
    assert rel(vol(d / "t" / "ph.vol"), vol(d / "j" / "ph.vol")) <= 1e-6


def _angles(path):
    md = MetaData(str(path))
    return np.array([[r["angleRot"], r["angleTilt"], r["anglePsi"]]
                     for r in (md.getRow(i) for i in md)])


@pytest.mark.parametrize("name,method", [("phantom_project", "fourier"),
                                         ("phantom_project", "real_space"),
                                         ("project", "fourier")])
def test_phantom_project_random_angles_match_the_reference(files, name,
                                                           method):
    d = files
    out = f"{name}_{method}"
    both(name, lambda t: ["-i", str(d / "ph.descr"), "-o",
                          str(d / t / f"{out}.stk"), "--nangles", "12",
                          "--seed", "4", "--method", method])
    np.testing.assert_array_equal(_angles(d / "t" / f"{out}.xmd"),
                                  _angles(d / "j" / f"{out}.xmd"))
    assert rel(vol(d / "t" / f"{out}.stk"), vol(d / "j" / f"{out}.stk")) \
        <= 1e-5


@pytest.mark.parametrize("case", ["single_shift", "params", "sym",
                                  "only_angles", "pdb"])
def test_phantom_project_options_match_the_reference(files, case):
    d = files
    if case == "params":
        MetaData.fromRows({"angleRot": 10.0 * i, "angleTilt": 15.0 * i,
                           "anglePsi": 5.0 * i, "itemId": i + 1}
                          for i in range(5)).write(str(d / "par.xmd"))
    extra = {"single_shift": ["--angles", "30", "40", "50", "1.5", "-2"],
             "params": ["--params", str(d / "par.xmd")],
             "sym": ["--nangles", "20", "--sym", "c2"],
             "only_angles": ["--nangles", "9", "--only_create_angles"],
             "pdb": ["--xdim", "24", "--sampling_rate", "2",
                     "--high_sampling_rate", "1"]}[case]
    src = d / ("model.pdb" if case == "pdb" else "ph.descr")
    out = "single.xmp" if case == "single_shift" else f"{case}.stk"
    both("phantom_project", lambda t: ["-i", str(src), "-o",
                                       str(d / t / out), *extra])
    if case == "only_angles":
        np.testing.assert_array_equal(_angles(d / "t" / f"{case}.xmd"),
                                      _angles(d / "j" / f"{case}.xmd"))
        return
    if case in ("params", "sym"):
        np.testing.assert_array_equal(_angles(d / "t" / f"{case}.xmd"),
                                      _angles(d / "j" / f"{case}.xmd"))
    assert rel(vol(d / "t" / out), vol(d / "j" / out)) <= 1e-5


def _ctf(d):
    c = CTFDescription(sampling_rate=2.0, voltage=300, Cs=2.7, Q0=0.1,
                       defocusU=12000, defocusV=13000, azimuthal_angle=30,
                       base_line=0.2, gaussian_K=1.5, sigmaU=20, sigmaV=25,
                       cU=0.05, cV=0.06, sqrt_K=0.8, sqU=3, sqV=4)
    c.write(str(d / "sim.ctfparam"))


@pytest.mark.parametrize("case", ["ctf_noise", "before_after",
                                  "defocus_change", "metadata_in"])
def test_phantom_simulate_microscope_matches_the_reference(files, case):
    d = files
    _ctf(d)
    if not (d / "j" / "proj.stk").exists():
        both("phantom_project", lambda t: [
            "-i", str(d / "ph.descr"), "-o", str(d / t / "proj.stk"),
            "--nangles", "8", "--seed", "2"])
    extra = {"ctf_noise": ["--ctf", str(d / "sim.ctfparam"), "--noise",
                           "0.3", "--downsampling", "1.5"],
             "before_after": ["--ctf", str(d / "sim.ctfparam"), "--noise",
                              "0.4", "--noise_before", "0.1",
                              "--after_ctf_noise"],
             "defocus_change": ["--ctf", str(d / "sim.ctfparam"),
                                "--defocus_change", "10", "--noise", "0.2",
                                "--seed", "7"],
             "metadata_in": ["--noise", "0.5"]}[case]
    src = "proj.xmd" if case == "metadata_in" else "proj.stk"
    both("phantom_simulate_microscope", lambda t: [
        "-i", str(d / "j" / src), "-o", str(d / t / f"sim_{case}.mrcs"),
        *extra])
    got, want = vol(d / "t" / f"sim_{case}.mrcs"), \
        vol(d / "j" / f"sim_{case}.mrcs")
    assert rel(got, want) <= 1e-5
