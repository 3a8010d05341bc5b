"""The Zernike3D and NMA flexibility programs (zernike_programs,
nma_programs and the first six programs of flex_misc_ext) against the
reference package's on the same files, on the CPU (the 8-blob phantom at
N=24, deformed by planted coefficients at L1=3, L2=2; 4 views of it with
CTFs; a 24-atom two-cluster model with 3 modes; 2 subtomograms; 16 views
of two deformed states), the port with --device cpu; the reference's 8
aliases of them, the flags the reference declares and never reads, which
the port refuses, and the registry's 185 endpoints.

Tolerances, relative to the max of the reference's output where not said:
- the host programs (nma_modes, pdb_nma_deform): equal files;
- volume_apply_coefficient_zernike3d: 1e-5 (the warp, or the 3-D KB
  splat with --blobr; float32 taps of the same field);
- volume_deform_sph (10 Adam steps, --sigma 0 1.5): the coefficients
  1e-3 (Adam's normalised steps carry the losses' float32 roundoff;
  tests/test_torch_zernike.py), the volumes 1e-3, the NCC 1e-4 absolute,
  the strain volumes 1e-3; forward_zernike_volume (8 steps at the
  reference's learning rate 0.5): 1e-2 (read 4.2e-3: the gradients agree
  to 3.3e-4 of their max at the first iterate, but the NCC's sums over
  the 24^3 splat cancel, its smallest entries carry 4e-3 relative
  roundoff, and Adam's normalised step turns that into 2e-3 a step), the
  NCC 1e-4;
- angular_sph_alignment, forward_zernike_images and its _priors twin (4
  Adam steps, 2 batches of 2 views, CTF rows): the coefficients 1e-3, the
  angles and shifts 1e-3 degrees or px, the defocus 1e-2 A, maxCC 1e-4
  absolute;
- nma_alignment_vol (20 steps, --mask, --filterVol, --opdb): the
  amplitudes 1e-3, maxCC 1e-4 absolute (read 1.4e-5), the PDB's
  coordinates 2e-3 A (written to 1e-3 A: amplitudes that agree to 1e-6
  can round to neighbouring last digits);
- nma_alignment and flexible_alignment (4 steps): the amplitudes 1e-3,
  the angles 1e-3 degrees, maxCC 1e-4 absolute. The reference's
  --projMatch reads the winner as mres["best_ref"], a key that its
  match_to_gallery does not return, and raises KeyError (ROADMAP.md
  section 3, item 22); the port is held, with --projMatch, against the
  reference run with that key added to its matcher's result;
- forward_zernike_subtomos (4 steps): as forward_zernike_images;
- art_zernike3d, forward_art_zernike3d_subtomos and
  cuda11_forward_art_zernike3d: the same k-means labels, the volumes
  5e-3 (each cluster's SIRT grids with K3's degree-7 window polynomial,
  the reference with the exact Bessel window: the kb tolerance of
  tests/test_torch_art.py), 1e-2 with --ltv and --ll1 (as there); the
  subtomogram path (the wedge-aware average) 1e-4;
- --mesh dp over 2 gloo ranks against the port's serial run (the same
  per-particle arithmetic on other batch shapes): 1e-5 of the max, or
  absolute below 1.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_cli_analysis import rel, rows, vol
from test_torch_nma import two_blob_model
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.pdb import read_pdb, write_pdb
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

N = 24
NEW = ["volume_deform_sph", "volume_apply_coefficient_zernike3d",
       "volume_apply_deform_sph", "angular_sph_alignment",
       "forward_zernike_volume", "forward_zernike_images",
       "forward_zernike_images_priors", "nma_modes", "nma_alignment_vol",
       "pdb_nma_deform", "nma_alignment", "flexible_alignment",
       "forward_zernike_subtomos", "art_zernike3d",
       "forward_art_zernike3d_subtomos", "cuda11_forward_art_zernike3d"]
NEW_ALIASES = ["cuda_volume_deform_sph", "cuda_angular_sph_alignment",
               "mpi_angular_sph_alignment", "mpi_forward_zernike_images",
               "mpi_forward_zernike_images_priors", "mpi_nma_alignment_vol",
               "mpi_nma_alignment", "mpi_forward_zernike_subtomos"]
MESHED = {"angular_sph_alignment", "forward_zernike_images",
          "forward_zernike_images_priors"}
CTF_ROW = {"ctfVoltage": 300.0, "ctfSphericalAberration": 2.7,
           "ctfQ0": 0.07}


def both(name, args_of):
    """Run `name` through both dispatchers; args_of(tag) gives each run's
    arguments ("j" for the reference, "t" for the port). Returns the two
    program objects."""
    progs = []
    for tag, get in (("j", jax_program), ("t", get_program)):
        prog = get(name)
        tail = ["-v", "0"] + (["--mesh", "none"] if name in MESHED else []) \
            + (["--device", "cpu"] if tag == "t" else [])
        with redirect_stdout(io.StringIO()):
            assert prog.run_with_args(
                [str(a) for a in args_of(tag)] + tail) == 0, tag
        progs.append(prog)
    return progs


def col(rs, k):
    return np.array([np.asarray(r[k], np.float64) for r in rs])


def hold_rows(d, fn, tols):
    """The two packages' output rows of d/{j,t}/fn, column by column:
    tols maps a label to ("rel", t) or ("abs", t)."""
    want, got = rows(d / "j" / fn), rows(d / "t" / fn)
    assert len(got) == len(want)
    for k, (kind, tol) in tols.items():
        w, g = col(want, k), col(got, k)
        assert g.shape == w.shape, k
        scale = np.abs(w).max() if kind == "rel" else 1.0
        assert np.abs(g - w).max() <= tol * scale, (k, np.abs(g - w).max())
    return want, got


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from xmipp3_tpu_torch.ops.continuous import _ctf_rfft
    from xmipp3_tpu_torch.ops.project import FourierProjector
    from xmipp3_tpu_torch.ops.zernike import (deform_volume,
                                              zernike_basis_grid)
    d = tmp_path_factory.mktemp("flex")
    for t in "jt":
        (d / t).mkdir()
    rng = np.random.default_rng(4)
    v = phantom8(N)
    save_image(str(d / "vol.vol"), v)
    basis = zernike_basis_grid(N, 3, 2)
    K = basis.shape[0]
    c = (rng.standard_normal((3, K)) * 0.6).astype(np.float32)
    dv = deform_volume(v, basis, c, device="cpu").numpy()
    save_image(str(d / "def.vol"), dv)
    MetaData.fromRows([{"sphCoefficients": c.ravel().astype(np.float64),
                        "image": "vol.vol"}]).write(str(d / "clnm.xmd"))
    # 4 views of the deformed phantom with CTFs
    B = 4
    rot = rng.uniform(0, 360, B).astype(np.float32)
    tilt = rng.uniform(30, 150, B).astype(np.float32)
    psi = rng.uniform(0, 360, B).astype(np.float32)
    views = FourierProjector(dv, device="cpu").project_euler(
        rot, tilt, psi).numpy()
    defU = rng.uniform(8000, 12000, B).astype(np.float32)
    fy = torch.fft.fftfreq(N)[:, None]
    fx = torch.fft.rfftfreq(N)[None, :]
    ctf = _ctf_rfft(torch.sqrt(fx * fx + fy * fy), fx, fy,
                    torch.as_tensor(defU), torch.as_tensor(defU * 0.97),
                    torch.full((B,), 20.0), (0.0197 * np.pi, 1e5, 0.997,
                                              0.07, 2.0), False)
    views = torch.fft.irfft2(torch.fft.rfft2(torch.as_tensor(views)) * ctf,
                             s=(N, N)).numpy()
    views = views + 0.02 * rng.standard_normal(views.shape).astype(
        np.float32)
    save_image(str(d / "views.mrcs"), views.astype(np.float32))
    MetaData.fromRows([dict(CTF_ROW, image=f"{i + 1:06d}@{d}/views.mrcs",
                            angleRot=float(rot[i] + 2), angleTilt=float(
                                tilt[i] - 1), anglePsi=float(psi[i]),
                            shiftX=0.0, shiftY=0.0,
                            ctfDefocusU=float(defU[i]),
                            ctfDefocusV=float(defU[i] * 0.97),
                            ctfDefocusAngle=20.0, itemId=i + 1)
                       for i in range(B)]).write(str(d / "views.xmd"))
    # the model, its modes, and views of its rasterized volume
    model = two_blob_model()
    write_pdb(str(d / "m.pdb"), model)
    # 2 subtomograms of the deformed phantom
    for i, ci in enumerate((c, -c)):
        save_image(str(d / f"sub{i}.vol"),
                   deform_volume(v, basis, ci, device="cpu").numpy())
    MetaData.fromRows([{"image": f"{d}/sub{i}.vol", "itemId": i + 1,
                        "angleRot": 0.0, "angleTilt": 0.0, "anglePsi": 0.0,
                        "sphCoefficients": (ci * 0.8).ravel().astype(
                            np.float64)}
                       for i, ci in enumerate((c, -c))]
                      ).write(str(d / "subs.xmd"))
    # 16 views of two deformed states, their rows carrying the state's
    # coefficients and a CTF
    art_rows, art_views = [], []
    for ci in (c, -c):
        dvi = deform_volume(v, basis, ci, device="cpu").numpy()
        r8 = rng.uniform(0, 360, 8).astype(np.float32)
        t8 = np.degrees(np.arccos(rng.uniform(-1, 1, 8))).astype(np.float32)
        p8 = rng.uniform(0, 360, 8).astype(np.float32)
        art_views.append(FourierProjector(dvi, device="cpu").project_euler(
            r8, t8, p8).numpy())
        art_rows += [dict(CTF_ROW, angleRot=float(r8[k]),
                          angleTilt=float(t8[k]), anglePsi=float(p8[k]),
                          ctfDefocusU=9000.0, ctfDefocusV=9000.0,
                          ctfDefocusAngle=0.0,
                          sphCoefficients=ci.ravel().astype(np.float64))
                     for k in range(8)]
    save_image(str(d / "art.mrcs"), np.concatenate(art_views))
    for i, r in enumerate(art_rows):
        r["image"] = f"{i + 1:06d}@{d}/art.mrcs"
    MetaData.fromRows(art_rows).write(str(d / "art.xmd"))
    return d


def test_volume_apply_coefficient_zernike3d(data):
    d = data
    for extra, fn in (([], "app.vol"), (["--blobr", 1.5], "app_blob.vol")):
        both("volume_apply_coefficient_zernike3d", lambda t: [
            "-i", d / "vol.vol", "--clnm", d / "clnm.xmd", "-o",
            d / t / fn, *extra])
        assert rel(vol(d / "t" / fn), vol(d / "j" / fn)) <= 1e-5
    assert rel(vol(d / "t" / "app.vol"), vol(d / "def.vol")) <= 1e-5


@pytest.mark.parametrize("name", ["volume_deform_sph",
                                  "forward_zernike_volume"])
def test_volume_fits(data, name):
    d = data
    extra = ["--sigma", 0, 1.5, "--steps", 10] \
        if name == "volume_deform_sph" else ["--steps", 8]
    pj, pt = both(name, lambda t: [
        "-i", d / "vol.vol", "-r", d / "def.vol", "-o",
        d / t / f"{name}.vol", "--oroot", d / t / name, "--analyzeStrain",
        *extra])
    tol = 1e-3 if name == "volume_deform_sph" else 1e-2
    hold_rows(d, f"{name}.xmd", {"sphCoefficients": ("rel", tol),
                                 "sphDeformation": ("rel", tol)})
    assert abs(pt.ncc - pj.ncc) <= 1e-4
    for suffix in (".vol", "_strain.vol", "_rotation.vol"):
        assert rel(vol(d / "t" / f"{name}{suffix}"),
                   vol(d / "j" / f"{name}{suffix}")) <= tol


@pytest.mark.parametrize("name", ["angular_sph_alignment",
                                  "forward_zernike_images"])
def test_per_particle_fits(data, name):
    d = data
    extra = ["--useCTF"] if name == "forward_zernike_images" else []
    both(name, lambda t: [
        "-i", d / "views.xmd", "--ref", d / "vol.vol", "-o",
        d / t / f"{name}.xmd", "--steps", 4, "--batch", 2,
        "--optimizeAlignment", "--optimizeDeformation", "--optimizeDefocus",
        "--sampling", 2.0, "--max_resolution", 5, *extra])
    hold_rows(d, f"{name}.xmd", {
        "sphCoefficients": ("rel", 1e-3), "angleRot": ("abs", 1e-3),
        "angleTilt": ("abs", 1e-3), "anglePsi": ("abs", 1e-3),
        "shiftX": ("abs", 1e-3), "shiftY": ("abs", 1e-3),
        "ctfDefocusU": ("abs", 1e-2), "maxCC": ("abs", 1e-4)})
    if name == "forward_zernike_images":
        # the priors twin seeded from this output's coefficients
        both("forward_zernike_images_priors", lambda t: [
            "-i", d / t / f"{name}.xmd", "--ref", d / "vol.vol", "-o",
            d / t / "priors.xmd", "--steps", 3, "--l1", 3, "--l2", 2])
        hold_rows(d, "priors.xmd", {"sphCoefficients": ("rel", 1e-3),
                                    "maxCC": ("abs", 1e-4)})


@pytest.fixture(scope="module")
def modes(data):
    d = data
    both("nma_modes", lambda t: ["-i", d / "m.pdb", "--oroot",
                                 d / t / "nm", "--nmodes", 3])
    for t in "jt":
        # mode files of each run under its own directory
        files = [str(d / t / f"nm_mode{i:03d}.mod") for i in (1, 2, 3)]
        open(d / t / "modes.txt", "w").write("\n".join(files))
    both("pdb_nma_deform", lambda t: [
        "--pdb", d / "m.pdb", "-o", d / t / "def.pdb", "--nma",
        d / t / "nm_modes.xmd", "--deformations", 2.0, -1.0, 0.5])
    return d


def test_nma_modes_and_pdb_deform(modes):
    d = modes
    for i in (1, 2, 3):
        assert (d / "t" / f"nm_mode{i:03d}.mod").read_text() == \
            (d / "j" / f"nm_mode{i:03d}.mod").read_text()
    assert (d / "t" / "def.pdb").read_text() == \
        (d / "j" / "def.pdb").read_text()


def test_nma_alignment_vol(modes):
    from xmipp3_tpu_torch.core.pdb import rasterize
    d = modes
    model = read_pdb(str(d / "m.pdb"))
    save_image(str(d / "nma_ref.vol"),
               rasterize(model, N, 1.0, sigma_a=1.5, center=False))
    save_image(str(d / "nma_t.vol"),
               rasterize(read_pdb(str(d / "j" / "def.pdb")), N, 1.0,
                         sigma_a=1.5, center=False))
    ref = np.squeeze(vol(d / "nma_ref.vol"))
    save_image(str(d / "nma_mask.vol"),
               (ref > 0.02 * ref.max()).astype(np.float32))
    pj, pt = both("nma_alignment_vol", lambda t: [
        "-i", d / "nma_t.vol", "--pdb", d / "m.pdb", "--modes",
        d / t / "nm_modes.xmd", "--vol", d / "nma_ref.vol", "-o", "amp.xmd",
        "--odir", d / t, "--steps", 20, "--mask", d / "nma_mask.vol",
        "--filterVol", 4, "--opdb", d / t / "opdb.pdb"])
    hold_rows(d, "amp.xmd", {"nmaDisplacements": ("rel", 1e-3),
                             "maxCC": ("abs", 1e-4)})
    assert np.abs(read_pdb(str(d / "t" / "opdb.pdb")).coords
                  - read_pdb(str(d / "j" / "opdb.pdb")).coords).max() <= 2e-3


@pytest.fixture(scope="module")
def nma_views(modes):
    from xmipp3_tpu_torch.core.pdb import rasterize
    from xmipp3_tpu_torch.ops.project import FourierProjector
    d = modes
    rng = np.random.default_rng(5)
    B = 3
    rot = rng.uniform(-180, 180, B).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(0.3, 1, B))).astype(np.float32)
    dv = rasterize(read_pdb(str(d / "j" / "def.pdb")), N, 1.0)
    views = FourierProjector(dv, device="cpu").project_euler(
        rot, tilt, np.zeros(B, np.float32)).numpy()
    save_image(str(d / "nma_views.mrcs"), views)
    MetaData.fromRows([{"image": f"{i + 1:06d}@{d}/nma_views.mrcs",
                        "angleRot": float(rot[i] + 3),
                        "angleTilt": float(tilt[i]), "anglePsi": 0.0,
                        "itemId": i + 1} for i in range(B)]
                      ).write(str(d / "nma_views.xmd"))
    return d


@pytest.mark.parametrize("name,extra", [
    ("nma_alignment", ["--steps", 4, "--gaussian_Real", 0.4]),
    ("flexible_alignment", ["--max_iter", 4, "--zerofreq_weight", 0.5])])
def test_nma_image_alignment(nma_views, name, extra):
    d = nma_views
    both(name, lambda t: [
        "-i", d / "nma_views.xmd", "--pdb", d / "m.pdb", "--modes",
        d / t / "modes.txt", "-o", f"{name}.xmd", "--odir", d / t, *extra])
    hold_rows(d, f"{name}.xmd", {
        "nmaDisplacements": ("rel", 1e-3), "angleRot": ("abs", 1e-3),
        "angleTilt": ("abs", 1e-3), "anglePsi": ("abs", 1e-3),
        "maxCC": ("abs", 1e-4)})


def test_nma_alignment_proj_match(nma_views, monkeypatch):
    import xmipp3_tpu.ops.match as jmatch
    d = nma_views
    args = lambda t: ["-i", d / "nma_views.xmd", "--pdb", d / "m.pdb",
                      "--modes", d / t / "modes.txt", "-o", "pm.xmd",
                      "--odir", d / t, "--steps", 3, "--projMatch",
                      "--discrAngStep", 30]
    with pytest.raises(KeyError, match="best_ref"):
        prog = jax_program("nma_alignment")
        prog.read(["xmipp_nma_alignment"]
                  + [str(a) for a in args("j")] + ["-v", "0"])
        prog.run()
    match = jmatch.match_to_gallery
    monkeypatch.setattr(jmatch, "match_to_gallery", lambda *a, **k: dict(
        (lambda r: {**r, "best_ref": r["ref_idx"]})(match(*a, **k))))
    both("nma_alignment", args)
    hold_rows(d, "pm.xmd", {
        "nmaDisplacements": ("rel", 1e-3), "angleRot": ("abs", 1e-3),
        "angleTilt": ("abs", 1e-3), "anglePsi": ("abs", 1e-3),
        "maxCC": ("abs", 1e-4)})


def test_forward_zernike_subtomos(data):
    d = data
    both("forward_zernike_subtomos", lambda t: [
        "-i", d / "subs.xmd", "--ref", d / "vol.vol", "-o", "fzs.xmd",
        "--odir", d / t, "--steps", 4, "--optimizeAlignment",
        "--optimizeDeformation", "--max_resolution", 3])
    hold_rows(d, "fzs.xmd", {
        "sphCoefficients": ("rel", 1e-3), "angleRot": ("abs", 1e-3),
        "shiftZ": ("abs", 1e-3), "maxCC": ("abs", 1e-4)})


@pytest.mark.parametrize("name,inp,extra,tol", [
    ("art_zernike3d", "art.xmd", ["--useCTF", "--niter", 1], 5e-3),
    ("cuda11_forward_art_zernike3d", "art.xmd",
     ["--niter", 2, "--ltv", 1e-3, "--ll1", 1e-4, "--onlyPositive"], 1e-2),
    ("forward_art_zernike3d_subtomos", "subs.xmd", ["--useZernike"], 1e-4)])
def test_zernike_reconstructions(data, name, inp, extra, tol):
    d = data
    pj, pt = both(name, lambda t: [
        "-i", d / inp, "-o", d / t / f"{name}.vol", "--clusters", 2,
        *extra])
    np.testing.assert_array_equal(pt.labels, pj.labels)
    assert len(set(pt.labels)) == 2
    assert rel(vol(d / "t" / f"{name}.vol"),
               vol(d / "j" / f"{name}.vol")) <= tol


# -- aliases, refused flags, the registry ---------------------------------

@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_volume_apply_deform_sph_is_the_apply_program():
    assert type(get_program("volume_apply_deform_sph")) is \
        type(get_program("volume_apply_coefficient_zernike3d"))


REFUSED = {
    "forward_zernike_volume": (["-i", "V", "-r", "V", "-o", "O",
                                "--optimizeRadius"], "--optimizeRadius"),
    "flexible_alignment": (["-i", "P", "--pdb", "M", "--modes", "T", "-o",
                            "O", "--maxdefamp", "100"], "--maxdefamp"),
    "art_zernike3d": (["-i", "A", "-o", "O", "--ref", "V"], "--ref"),
    "forward_art_zernike3d_subtomos": (["-i", "A", "-o", "O", "--blobr",
                                        "2"], "--blobr"),
    "cuda11_forward_art_zernike3d": (["-i", "A", "-o", "O", "--mr", "2"],
                                     "--mr"),
    "nma_alignment_vol": (["-i", "V", "--pdb", "M", "--modes", "T", "-o",
                           "O", "--alignVolumes", "0.3", "10"],
                          "--alignVolumes"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_flags_the_reference_never_reads_are_refused(data, tmp_path, name,
                                                      capsys):
    args, flag = REFUSED[name]
    sub = {"V": str(data / "vol.vol"), "O": str(tmp_path / "out"),
           "P": str(data / "views.xmd"), "M": str(data / "m.pdb"),
           "T": str(tmp_path / "none.txt"), "A": str(data / "art.xmd")}
    assert get_program(name).run_with_args(
        [sub.get(a, a) for a in args] + ["--device", "cpu", "-v", "0"]) == 1
    err = capsys.readouterr().err
    assert flag in err and "item 21" in err


@pytest.mark.parametrize("name,args", [
    ("art_zernike3d", ["-i", "A", "-o", "O", "--sort_last", "3"]),
    ("cuda11_forward_art_zernike3d", ["-i", "A", "-o", "O",
                                      "--sort_random"])])
def test_flags_that_change_nothing_stay_accepted(data, tmp_path, name, args):
    sub = {"A": str(data / "art.xmd"), "O": str(tmp_path / "o.vol")}
    with redirect_stdout(io.StringIO()):
        assert get_program(name).run_with_args(
            [sub.get(a, a) for a in args]
            + ["--niter", "1", "--device", "cpu", "-v", "0"]) == 0


def test_the_registry_holds_185_endpoints():
    from xmipp3_tpu_torch.programs import list_programs
    import test_torch_cli_flex_tail as flex_tail
    import test_torch_cli_tail as tail
    import test_torch_cli_tomo as tomo
    names = set(list_programs())
    assert set(NEW) | set(NEW_ALIASES) <= names
    assert len(NEW) == 16 and len(NEW_ALIASES) == 8
    # the endpoints of the later slices (tests/test_torch_cli_flex_tail.py,
    # tests/test_torch_cli_tomo.py, tests/test_torch_cli_tail.py) aside
    later = set().union(*(set(m.NEW) | set(m.NEW_ALIASES)
                          for m in (flex_tail, tomo, tail)))
    assert len(names - later) == 185 and len(set(ALIASES) - later) == 54


@pytest.mark.parametrize("name", ["angular_sph_alignment",
                                  "forward_zernike_images"])
def test_mesh_dp_equals_serial(data, tmp_path, name):
    """--mesh dp over 2 gloo ranks: each rank fits its own rows of every
    batch (3 views, then 1, each padded by repeating its first row), and
    the rows meet in one all_gather: the serial run's rows."""
    from test_torch_common import Ranks
    d = data
    argv = lambda out: [
        "-i", str(d / "views.xmd"), "--ref", str(d / "vol.vol"), "-o",
        str(out), "--steps", "3", "--batch", "3", "--optimizeAlignment",
        "--optimizeDeformation", "--sampling", "2.0"] + (
        ["--useCTF"] if name == "forward_zernike_images" else [])
    with redirect_stdout(io.StringIO()):
        assert get_program(name).run_with_args(
            argv(tmp_path / "serial.xmd") + ["--device", "cpu", "-v",
                                             "0"]) == 0
    ranks = Ranks(2, [{"name": "dp", "program": name, "argv": argv(
        tmp_path / "mesh.xmd") + ["--mesh", "dp"]}], tmp_path, {})
    for rep in ranks.join():
        assert rep["jobs"]["dp"]["rc"] == 0, rep
    serial, mesh = rows(tmp_path / "serial.xmd"), rows(tmp_path / "mesh.xmd")
    assert [r["image"] for r in mesh] == [r["image"] for r in serial]
    for k in ("sphCoefficients", "angleRot", "angleTilt", "anglePsi",
              "shiftX", "shiftY", "maxCC"):
        w, g = col(serial, k), col(mesh, k)
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), k
