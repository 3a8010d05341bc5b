"""The mesh paths of the port (xmipp3_tpu_torch.parallel) against the
reference's on the CPU, and backproject_chunk's kz-slab mode.

- backproject_chunk(slab_p, slab_z0) against the reference's (its XLA path)
  at N=32, P=64, slabs of 16 and 32 planes at several origins: kb <= 5e-3
  (K3's degree-7 window polynomial against the exact Bessel window), tri,
  tri+kb and nn <= 1e-4, each relative to the max of the channel over the
  full cube. (The roundoff of the two packages' 2-D FFTs is absolute, set
  by the DC term; a slab far from the cube's centre holds only small
  high-frequency values, and the full-cube accumulators agree to 3e-7 of
  their max.) The slabs of a z partition, stacked, equal the port's full
  cube to 1e-5 * max.
- Ranks of a gloo process group, spawned as processes of their own on the
  CPU (2, and 4 for slab2d), against the reference on a mesh of its
  virtual CPU devices (tests/conftest.py): the three reconstructors
  (1e-4, trilinear and nearest-neighbour windows), the five matchers (the
  agreement of test_torch_match.py), and both programs under --mesh
  dp|tp|slab|slab2d|auto (volumes 1e-4, assignment rows as in
  test_torch_cli_match.py). Every rank returns the same result, only rank
  0 writes files, and no rank imports jax or the reference package.
- local_align_mesh on 2 ranks (the patch axis sharded): its field equals
  the port's serial local_align to 1e-3 px and the reference's
  local_align_mesh on 2 virtual devices to 0.02 px, on every rank; and
  movie_alignment_correlation --mesh dp on 2 ranks writes (rank 0 only)
  the shifts and average of the port's serial run (1e-4).
- parallel_art_correction on 2 ranks (a 15-view block padded to 16)
  against the reference's on 2 virtual devices (1e-4), and
  reconstruct_art, align_significant (its ranks started through
  torchrun's environment) and reconstruct_significant under --mesh dp on
  2 ranks against the serial port and the reference's run on its virtual
  mesh: ART's volume 1e-4; align_significant's rows and updated
  references equal to the serial port's (the ranks score the serial
  run's --batch chunks); reconstruct_significant's rows equal to the
  serial port's (the same chunks) and its volume 1e-4 of them, its views
  and weights (1e-4) the reference's, its volume correlated 0.99 with the
  reference's.
- parallel_class_sums on 2 ranks against the serial sums (1e-5 * max) and
  the reference's on 2 virtual devices (1e-5 * max), and
  angular_class_average --mesh dp --split on 2 ranks against the serial
  port: averages and halves 1e-5 * max, counts equal (the ranks draw the
  serial path's halves). The reference's mesh path draws its halves
  otherwise than its serial path (ROADMAP.md section 3, item 14): its mesh
  halves are held to differ from its serial ones, its averages to agree.
- parallel_pca_components on 2 ranks (91 samples padded to 92) against
  the port's serial SVD components and the reference's on 2 virtual
  devices, up to sign (1e-4: float32 moments, float64 eigh), and
  parallel_filter_bank (bands dealt in turn) against the serial
  filter_bank (1e-5 * max: the sums' order differs) and the reference's
  (5e-5, the tolerance of tests/test_torch_halves.py; read 1.1e-5);
  image_rotational_pca and volume_halves_restoration under --mesh dp on 2
  ranks against their serial runs (each principal angle of the bases
  <= 1e-3 rad; the restored volumes 1e-5 * max) and the reference's mesh
  runs (the same angles; the volumes 5e-5, read 1.2e-5).
- On one rank (no process group): --mesh auto is the serial path, and
  dp|tp|slab|slab2d raise the reference's RuntimeError.

The ranks of one process group share their spawn across the checks; each
spawn is joined within RANK_TIMEOUT_S.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh
from test_torch_cli_match import _hold_rows, _rows
from test_torch_common import Ranks, phantom_batch, rel_err
from test_torch_match import _hold
from test_torch_project import phantom8
from xmipp3_tpu.ops import halves_restoration as jhr
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu.parallel import match as jpm
from xmipp3_tpu.parallel import reconstruct as jpr
from xmipp3_tpu.parallel import engines as jpe
from xmipp3_tpu.parallel.engines import parallel_class_sums as jax_class_sums
from xmipp3_tpu.parallel.mesh import data_mesh as jax_data_mesh
from xmipp3_tpu.parallel.movie import local_align_mesh as jax_local_align_mesh
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.sampling import directions_from_angles
from xmipp3_tpu_torch.ops import movie as tmovie
from xmipp3_tpu_torch.ops import reconstruct as trec
from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
from xmipp3_tpu_torch.parallel.cli import resolve_mesh
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)

N, P, C, B = 32, 64, 15, 23      # odd C and B: the meshes pad them
TOL = {"tri": 1e-4, "tri+kb": 1e-4, "nn": 1e-4, "kb": 5e-3}


# -- backproject_chunk in kz-slab mode ---------------------------------------

def _chunk(seed=5, count=8):
    b = phantom_batch(seed, count, N)
    mats = np.asarray(euler_matrix(b["rot"], b["tilt"], b["psi"]),
                      np.float32)
    return b, mats


def _port_slab(b, mats, interp, slab_p=None, z0=0):
    zdim = P if slab_p is None else slab_p
    acc = [torch.zeros((zdim, P, P)) for _ in range(3)]
    trec.backproject_chunk(*acc, b["imgs"], mats, b["sx"], b["sy"], b["w"], P,
                           0.5, slab_p=slab_p, slab_z0=z0, interp=interp)
    return acc


SLABS = [(16, 0), (16, 24), (16, 48), (32, 0), (32, 16), (32, 32)]


@pytest.fixture(scope="module")
def reference_slabs():
    """The reference's slab accumulators for each interp and slab, on its
    XLA path op by op (jax.disable_jit): the operations its jitted CPU path
    runs, without a compile of the 64-tap exact-Bessel expansion for every
    slab size."""
    b, mats = _chunk()
    out = {}
    for interp in TOL:
        for slab_p, z0 in SLABS + [(P, 0)]:
            z = jax.numpy.zeros((slab_p, P, P))
            with jax.disable_jit():
                got = jrec.backproject_chunk(
                    z, z, z, b["imgs"], mats, b["sx"], b["sy"], b["w"], P,
                    0.5, slab_p=slab_p, slab_z0=z0, interp=interp)
            out[interp, slab_p, z0] = [np.asarray(a) for a in got]
    return out


@pytest.mark.parametrize("slab_p,z0", SLABS)
@pytest.mark.parametrize("interp", list(TOL))
def test_backproject_slab_matches_the_reference(reference_slabs, interp,
                                                slab_p, z0):
    b, mats = _chunk()
    got = _port_slab(b, mats, interp, slab_p, z0)
    want = reference_slabs[interp, slab_p, z0]
    full = reference_slabs[interp, P, 0]
    for g, w, f in zip(got, want, full):
        assert g.shape == (slab_p, P, P)
        assert np.abs(w).max() > 0
        assert np.abs(g.numpy() - w).max() <= TOL[interp] * np.abs(f).max()


@pytest.mark.parametrize("interp", list(TOL) + ["wide kb"])
def test_slabs_of_a_partition_stack_to_the_full_cube(interp):
    """Slabs [0, 16), [16, 48) and [48, 64), stacked, against the full
    cube (through K3, K1, K5, and K2 for the full trilinear cube)."""
    b, mats = _chunk(6)
    blob = dict(blob=(2.5, 0, 10.0)) if interp == "wide kb" else {}
    interp = interp.split()[-1]

    def run(slab_p=None, z0=0):
        zdim = P if slab_p is None else slab_p
        acc = [torch.zeros((zdim, P, P)) for _ in range(3)]
        trec.backproject_chunk(*acc, b["imgs"], mats, b["sx"], b["sy"],
                               b["w"], P, 0.5, slab_p=slab_p, slab_z0=z0,
                               interp=interp, **blob)
        return acc

    full = run()
    parts = [run(hi - lo, lo) for lo, hi in ((0, 16), (16, 48), (48, 64))]
    for k in range(3):
        stacked = torch.cat([p[k] for p in parts])
        assert rel_err(stacked, full[k]) <= 1e-5


# -- spawned ranks against the reference's virtual mesh ---------------------

def _rec_dataset(d):
    b = phantom_batch(21, C, N)
    stk = str(d / "parts.mrcs")
    save_image(stk, b["imgs"])
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(b["rot"][i]),
         "angleTilt": float(b["tilt"][i]), "anglePsi": float(b["psi"][i]),
         "shiftX": float(b["sx"][i]), "shiftY": float(b["sy"][i]),
         "weight": float(b["w"][i]), "flip": int(b["flip"][i])}
        for i in range(C)).write(str(d / "parts.xmd"))
    # the same rows with inline CTF labels, for --useCTF: CTFs with |c| >=
    # --minCTF 0.3 at every sample (Q0 0.7, 1,500-2,500 A at 4 A/px), where
    # the reference's CPU path, which drops the weight modulator
    # (tests/test_torch_reconstruct_ctf.py), grids what the port grids
    md = MetaData(str(d / "parts.xmd"))
    for k, lbl in (("ctfSamplingRate", 4.0), ("ctfVoltage", 300.0),
                   ("ctfSphericalAberration", 2.7), ("ctfQ0", 0.7)):
        md.setColumnValues(k, [lbl] * C)
    md.setColumnValues("ctfDefocusU", [1500.0 + 60 * i for i in range(C)])
    md.setColumnValues("ctfDefocusV", [1600.0 + 60 * i for i in range(C)])
    md.setColumnValues("ctfDefocusAngle", [13.0 * i for i in range(C)])
    md.write(str(d / "parts_ctf.xmd"))
    # a class assignment of the views for angular_class_average
    rows = _rows(d / "parts.xmd")
    MetaData.fromRows(dict(r, ref=CLASS_OF(i) + 1, maxCC=0.5)
                      for i, r in enumerate(rows)).write(str(d / "ca.xmd"))
    # the slab reconstructors take no flips: the programs mirror flipped
    # images and negate their shiftX first
    f = b["flip"]
    b["imgs_f"] = np.where(f[:, None, None], b["imgs"][:, :, ::-1], b["imgs"])
    b["sx_f"] = np.where(f, -b["sx"], b["sx"]).astype(np.float32)
    return b


def _match_dataset(d):
    vol = d / "vol.vol"
    save_image(str(vol), phantom8(N))
    for side, prog, dev in (("ref", jax_program, []),
                            ("port", get_program, ["--device", "cpu"])):
        assert prog("angular_project_library").run_with_args(
            ["-i", str(vol), "-o", str(d / side), "--sampling_rate", "15",
             "-v", "0"] + dev) == 0
    refs = np.squeeze(Image(str(d / "ref.stk")).data)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(refs), B)
    imgs = apply_alignment_2d(
        refs[idx], rng.uniform(-180, 180, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32), device="cpu").numpy()
    imgs += 0.1 * refs.std() * rng.standard_normal(imgs.shape).astype(
        np.float32)
    stk = d / "views.mrcs"
    save_image(str(stk), imgs)
    MetaData.fromRows({"image": f"{i + 1}@{stk}", "itemId": i + 1}
                      for i in range(B)).write(str(d / "views.xmd"))
    allowed = (rng.uniform(size=(B, len(refs))) < 0.5).astype(np.float32)
    return refs, imgs, allowed


N_CLASSES = 4
CLASS_OF = lambda i: (7 * i) % N_CLASSES
CLASS_SUMS = dict(args=["imgs", "psi", "sx", "sy", "flipf", "assign"],
                  arrays={"sel_weights": "selw"},
                  kwargs={"n_refs": N_CLASSES}, mesh="data",
                  fn="parallel_class_sums")
PCA = dict(args=["pca_X"], kwargs={"n_eig": 4}, mesh="data",
           fn="parallel_pca_components")
HN = 16                                  # the half maps of the filter bank
BANK_KW = {"shape": [HN] * 3, "bank_step": 0.1, "bank_overlap": 0.5,
           "weight_fun": 2, "weight_power": 3.0}
BANK = dict(args=["h1", "h2", "hr2"], kwargs=BANK_KW, mesh="data",
            fn="parallel_filter_bank")
REC = dict(args=["imgs", "rot", "tilt", "psi", "sx", "sy"],
           arrays={"weights": "w", "flip": "flip"})
SLAB = dict(args=["imgs_f", "rot", "tilt", "psi", "sx_f", "sy"],
            arrays={"weights": "w"})
MATCH = dict(args=["refs", "mimgs"], kwargs={"max_shift": 4})
FUNCS = {  # name -> (ranks, job); kwargs beside the inputs' arrays
    "parallel_reconstruct": (2, dict(REC, mesh="data", kwargs={
        "interp": "tri", "sym": "c2", "batch": 4})),
    "slab_reconstruct": (2, dict(SLAB, mesh="data", kwargs={
        "interp": "tri", "batch": 4})),
    "slab_reconstruct_2d": (4, dict(SLAB, mesh="slab2d", kwargs={
        "interp": "tri", "batch": 4})),
    # P = 58 is no multiple of 4 ranks: padded to 60, 15 planes a slab
    "slab_reconstruct_padded": (4, dict(SLAB, mesh="data", fn=
                                        "slab_reconstruct", kwargs={
        "interp": "nn", "pad_factor": 1.8125})),
    "parallel_match": (2, dict(MATCH, mesh="data")),
    "parallel_match_full": (2, dict(MATCH, mesh="data",
                                    arrays={"allowed": "allowed"}, kwargs={
        "max_shift": 4, "n_orientations": 2})),
    "parallel_match_score_matrix": (2, dict(MATCH, mesh="data")),
    "parallel_match_tp": (2, dict(MATCH, mesh="model")),
    "parallel_match_refsharded": (2, dict(MATCH, mesh="model")),
    # one ART block of C = 15 views on 2 ranks: padded to 16 with a row of
    # weight 0
    "parallel_art_correction": (2, dict(args=["art_vol", "imgs", "rot",
                                              "tilt", "psi"], mesh="data")),
}
REC_MODES = {"dp": 2, "slab": 2, "slab2d": 4, "auto": 2, "tp": 2,
             "slab_ctf": 2}
CTF_FLAGS = ["--useCTF", "--sampling", "4", "--minCTF", "0.3"]
MATCH_MODES = {"dp": 2, "tp": 2, "slab": 2, "slab2d": 4, "auto": 2}


# local_align_mesh on 2 ranks: (patches, patch size, max shift, avg)
MOVIE_KW = {"patches": [3, 3], "patch_size": 96, "max_shift_px": 4,
            "patches_avg": 3}
MOVIE_FLAGS = ["--patches", "3", "3", "--minLocalRes", "96", "--maxShift",
               "10", "--sampling", "1"]


def _movie_dataset(d):
    """tests/test_mesh_cli.py:138's movie: crops of one random field moved
    by (-i, +i) px a frame; its global positions; written as a stack."""
    rng = np.random.default_rng(0)
    F, H, W = 6, 256, 256
    base = rng.standard_normal((H + 16, W + 16)).astype(np.float32)
    frames = np.stack([base[4 + i: 4 + i + H, 8 - i: 8 - i + W]
                       for i in range(F)])
    save_image(str(d / "movie.mrcs"), frames)
    return frames, tmovie.global_align(frames, 10, device="cpu")


# the mesh runs of reconstruct_art, align_significant (its ranks meet
# through torchrun's environment: the program has no --dist_* flags) and
# reconstruct_significant; argv(d, tag) writes under d/tag
SLICE12_MESH = {
    "art_dp": ("reconstruct_art", lambda d, t: [
        "-i", str(d / "parts.xmd"), "-o", str(d / f"art_{t}.vol"),
        "--parallel_mode", "pSART", "--block_size", "5", "-n", "2"], {}),
    "asig_dp": ("align_significant", lambda d, t: [
        "-i", str(d / "views.xmd"), "-r", str(d / "port.doc"), "-o",
        str(d / f"asig_{t}.xmd"), "--max_shift", "4", "--batch", "4",
        "--keepBestN", "2", "--oUpdatedRefs", str(d / f"upd_{t}")],
        {"rendezvous": "env"}),
    "rpca_dp": ("image_rotational_pca", lambda d, t: [
        "-i", str(d / "views.xmd"), "--oroot", str(d / f"rpca_{t}"),
        "--eigenvectors", "4", "--psi_step", "45"], {}),
    "halves_dp": ("volume_halves_restoration", lambda d, t: [
        "--i1", str(d / "half1.vol"), "--i2", str(d / "half2.vol"),
        "--oroot", str(d / f"halves_{t}"), "--denoising", "1",
        "--filterBank", "0.05", "0.5", "1", "3", "--difference", "1"], {}),
    "rsig_dp": ("reconstruct_significant", lambda d, t: [
        "-i", str(d / "views.xmd"), "--odir", str(d / f"rsig_{t}"),
        "--iter", "1", "--angularSampling", "15", "--maxShift", "4",
        "--initvolumes", str(d / "vol.vol")], {}),
    "classavg_dp": ("angular_class_average", lambda d, t: [
        "-i", str(d / "ca.xmd"), "--lib", str(d / "ref.doc"), "-o",
        str(d / f"classavg_{t}"), "--split", "--limitRclass", "10"], {}),
}


def _cli_jobs(d, ranks):
    jobs = []
    if ranks == 2:
        jobs.append({"name": "movie_dp", "program":
                     "movie_alignment_correlation", "argv": [
                         "-i", str(d / "movie.mrcs"), "-o",
                         str(d / "movie_dp.xmd"), "--oavg",
                         str(d / "movie_dp.mrc"), "--mesh", "dp",
                         *MOVIE_FLAGS]})
    for mode, n in REC_MODES.items():
        if n == ranks:
            ctf = mode.endswith("_ctf")
            jobs.append({"name": f"rec_{mode}", "program":
                         "reconstruct_fourier", "argv": [
                             "-i", str(d / ("parts_ctf.xmd" if ctf else
                                            "parts.xmd")), "-o",
                             str(d / f"rec_{mode}.vol"), "--interp", "tri",
                             "--weight", "--batch", "4", "--mesh",
                             mode.split("_")[0]] + (CTF_FLAGS if ctf
                                                    else [])})
    if ranks == 2:
        jobs += [{"name": name, "program": prog, "argv": argv(d, "mesh")
                  + ["--mesh", "dp"], **extra}
                 for name, (prog, argv, extra) in SLICE12_MESH.items()]
    for mode, n in MATCH_MODES.items():
        if n == ranks:
            jobs.append({"name": f"match_{mode}", "program":
                         "angular_projection_matching", "argv": [
                             "-i", str(d / "views.xmd"), "-o",
                             str(d / f"match_{mode}.xmd"), "--ref",
                             str(d / "port"), "--max_shift", "4", "--batch",
                             "16", "--mesh", mode]})
    return jobs


def _reference_funcs(inputs):
    """The reference's entry points on meshes of its virtual devices with
    the ranks' shapes."""
    devs = jax.devices()
    mesh = lambda n, axis="data": jax_data_mesh(n, axis_name=axis)
    a = lambda names: [inputs[k] for k in names]
    kw = lambda job: {k: inputs[v] for k, v in job.get("arrays",
                                                       {}).items()}
    out = {}
    for name, (n, job) in FUNCS.items():
        if name == "parallel_art_correction":
            corr, ss, rmax = jpr.parallel_art_correction(
                mesh(n), *a(job["args"]))
            out[name] = dict(out0=np.asarray(corr), out1=ss, out2=rmax)
            continue
        fn = getattr(jpr, job.get("fn", name), None) or \
            getattr(jpm, job.get("fn", name))
        m = (JaxMesh(np.array(devs[:n]).reshape(n // 2, 2), ("data", "z"))
             if job["mesh"] == "slab2d" else mesh(n, job["mesh"]))
        extra = {k: v for k, v in job.get("kwargs", {}).items()
                 if k != "batch"}         # the reference takes all at once
        got = fn(m, *a(job["args"]), **kw(job), **extra)
        out[name] = ({k: np.asarray(v) for k, v in got.items()}
                     if isinstance(got, dict) else np.asarray(got))
    return out


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Spawn the ranks (2 and 4, one gloo group a job), compute the
    reference's results meanwhile, and join them."""
    d = tmp_path_factory.mktemp("mesh")
    b = _rec_dataset(d)
    refs, mimgs, allowed = _match_dataset(d)
    inputs = {k: b[k] for k in ("imgs", "rot", "tilt", "psi", "sx", "sy",
                                "w", "flip", "imgs_f", "sx_f")}
    inputs.update(refs=refs, mimgs=mimgs, allowed=allowed,
                  art_vol=(0.5 * phantom8(N)).astype(np.float32))
    # the 15 views in 4 classes, 2 rejected by the selection weights
    inputs.update(flipf=b["flip"].astype(np.float32),
                  assign=np.array([CLASS_OF(i) for i in range(C)], np.int64),
                  selw=(np.arange(C) % 7 != 3).astype(np.float32))
    for t in ("mesh", "serial", "ref"):
        (d / f"rsig_{t}").mkdir()
    inputs["movie"], inputs["movie_pos"] = _movie_dataset(d)
    # 91 samples (padded to 92 on 2 ranks) of 64 features for the PCA
    # moments; two noisy half maps for the filter bank (written for the CLI
    # runs too)
    rng = np.random.default_rng(9)
    inputs["pca_X"] = (rng.standard_normal((91, 5)) * [6, 4, 3, 2, 1]
                       @ rng.standard_normal((5, 64))
                       + rng.standard_normal((91, 64))).astype(np.float32)
    hv = phantom8(HN, scale=0.3)
    for k in (1, 2):
        inputs[f"h{k}"] = (hv + 0.2 * rng.standard_normal(hv.shape)) \
            .astype(np.float32)
        save_image(str(d / f"half{k}.vol"), inputs[f"h{k}"])
    inputs["hr2"] = jhr.make_r2((HN,) * 3)
    spawns = {}
    for n in (2, 4):
        jobs = [dict(job, name=name, fn=job.get("fn", name))
                for name, (k, job) in FUNCS.items() if k == n]
        if n == 2:
            jobs.append({"name": "local_align_mesh", "fn":
                         "local_align_mesh", "mesh": "data",
                         "args": ["movie", "movie_pos"],
                         "kwargs": MOVIE_KW})
            jobs.append(dict(CLASS_SUMS, name="parallel_class_sums"))
            jobs.append(dict(PCA, name="parallel_pca_components"))
            jobs.append(dict(BANK, name="parallel_filter_bank"))
        (d / f"w{n}").mkdir()
        spawns[n] = Ranks(n, jobs + _cli_jobs(d, n), d / f"w{n}", inputs)

    ref = {"funcs": _reference_funcs(inputs)}
    kw = dict(MOVIE_KW, patches=tuple(MOVIE_KW["patches"]))
    ref["local_align_mesh"] = jax_local_align_mesh(
        jax_data_mesh(2), inputs["movie"], inputs["movie_pos"], **kw)
    ref["local_align"] = tmovie.local_align(
        inputs["movie"], inputs["movie_pos"], device="cpu", **kw)
    out = d / "movie_serial.xmd"
    assert get_program("movie_alignment_correlation").run_with_args(
        ["-i", str(d / "movie.mrcs"), "-o", str(out), "--oavg",
         str(d / "movie_serial.mrc"), "--device", "cpu", "-v", "0",
         *MOVIE_FLAGS]) == 0
    rec_args = ["-i", str(d / "parts.xmd"), "--interp", "tri", "--weight",
                "-v", "0"]
    for mode in ("dp", "slab", "slab2d"):
        out = d / f"ref_rec_{mode}.vol"
        assert jax_program("reconstruct_fourier").run_with_args(
            rec_args + ["-o", str(out), "--mesh", mode]) == 0
        ref[f"rec_{mode}"] = np.squeeze(Image(str(out)).data)
    out = d / "ref_rec_slab_ctf.vol"
    assert jax_program("reconstruct_fourier").run_with_args(
        ["-i", str(d / "parts_ctf.xmd"), "--interp", "tri", "--weight", "-v",
         "0", "-o", str(out), "--mesh", "slab"] + CTF_FLAGS) == 0
    ref["rec_slab_ctf"] = np.squeeze(Image(str(out)).data)
    with pytest.raises(KeyError, match="data"):
        jax_program("reconstruct_fourier").run_with_args(
            rec_args + ["-o", str(d / "ref_rec_tp.vol"), "--mesh", "tp"])
    for mode in ("dp", "tp"):
        out = d / f"ref_match_{mode}.xmd"
        assert jax_program("angular_projection_matching").run_with_args(
            ["-i", str(d / "views.xmd"), "-o", str(out), "--ref",
             str(d / "ref"), "--max_shift", "4", "--batch", "16", "--mesh",
             mode, "-v", "0"]) == 0
        ref[f"match_{mode}"] = _rows(out)
    for name, (prog, argv, _) in SLICE12_MESH.items():
        assert get_program(prog).run_with_args(
            argv(d, "serial") + ["--device", "cpu", "-v", "0"]) == 0
        assert jax_program(prog).run_with_args(
            argv(d, "ref") + ["--mesh", "dp", "-v", "0"]) == 0
    # the reference's class averages on its serial path too
    assert jax_program("angular_class_average").run_with_args(
        SLICE12_MESH["classavg_dp"][1](d, "refserial")
        + ["--mesh", "none", "-v", "0"]) == 0
    ref["class_sums"] = [np.asarray(v) for v in jax_class_sums(
        jax_data_mesh(2), *(inputs[k] for k in CLASS_SUMS["args"]),
        N_CLASSES, sel_weights=inputs["selw"])]
    ref["pca"] = jpe.parallel_pca_components(jax_data_mesh(2),
                                             inputs["pca_X"], 4)
    ref["bank"] = [np.asarray(v) for v in jpe.parallel_filter_bank(
        jax_data_mesh(2), *(inputs[k] for k in BANK["args"]),
        **dict(BANK_KW, shape=(HN,) * 3))]
    reports = {n: s.join() for n, s in spawns.items()}
    return dict(dir=d, ref=ref, reports=reports, gallery=_rows(d / "ref.doc"),
                angles=np.array([[r["angleRot"], r["angleTilt"]]
                                 for r in _rows(d / "ref.doc")]))


def _port_out(meshes, name, n, rank=0):
    with np.load(meshes["dir"] / f"w{n}" / f"out_{name}_r{rank}.npz") as z:
        return dict(z)


def test_ranks_import_neither_jax_nor_the_reference(meshes):
    for reps in meshes["reports"].values():
        for rep in reps:
            assert rep["modules"] == [], rep["rank"]


@pytest.mark.parametrize("name", [k for k in FUNCS if "match" not in k
                                  and k != "parallel_art_correction"])
def test_mesh_reconstructors_match_the_reference(meshes, name):
    n, job = FUNCS[name]
    got = _port_out(meshes, name, n)["vol"]
    assert got.shape == (N, N, N) and np.isfinite(got).all()
    assert rel_err(got, meshes["ref"]["funcs"][name]) <= \
        TOL[job["kwargs"]["interp"]]
    for r in range(1, n):                 # every rank holds the volume
        np.testing.assert_array_equal(_port_out(meshes, name, n, r)["vol"],
                                      got)


def _hold_scan(got, want, angles):
    """A coarse scan's winners, as test_torch_match's _hold holds a full
    match: the same (ref, flip, trial) for >= 98 % of the particles,
    counting in the exact tie (the antipodal direction with the other
    flip), and >= 80 % without it; the peaks to 1e-4 on both, psi to 0.5
    deg at the 98th percentile of the same ones."""
    d = directions_from_angles(angles)
    same = (got["ref_idx"] == want["ref_idx"]) & \
        (got["flip"] == want["flip"]) & (got["trial"] == want["trial"])
    tie = ~same & (got["flip"] != want["flip"]) & \
        ((d[got["ref_idx"]] * d[want["ref_idx"]]).sum(-1) < -0.9999)
    assert (same | tie).mean() >= 0.98
    assert same.mean() >= 0.8
    assert np.abs(got["peak"] - want["peak"])[same | tie].max() <= 1e-4
    dpsi = np.abs((got["psi"] - want["psi"] + 180) % 360 - 180)
    assert np.quantile(dpsi[same], 0.98) <= 0.5


@pytest.mark.parametrize("name", [k for k in FUNCS if "match" in k])
def test_mesh_matchers_match_the_reference(meshes, name):
    n = FUNCS[name][0]
    got = _port_out(meshes, name, n)
    want = dict(meshes["ref"]["funcs"][name])
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
    if name in ("parallel_match", "parallel_match_refsharded"):
        _hold_scan(got, want, meshes["angles"])
        if "valid" in got:
            np.testing.assert_array_equal(got["valid"], want["valid"])
    elif name == "parallel_match_score_matrix":
        np.testing.assert_array_equal(got["trials"], want["trials"])
        assert np.abs(got["peak"] - want["peak"]).max() <= 1e-4
    else:
        _hold(got, want, B, meshes["angles"])
    for r in range(1, n):                 # every rank holds the results
        for k, v in _port_out(meshes, name, n, r).items():
            np.testing.assert_array_equal(v, got[k])


def test_parallel_art_correction_matches_the_reference(meshes):
    """The block's correction (trilinear, 1e-4 of the max), its residual
    sum and max |residual| (1e-5 relative) on 2 ranks against the
    reference's on 2 virtual devices; every rank holds the same."""
    got = _port_out(meshes, "parallel_art_correction", 2)
    want = meshes["ref"]["funcs"]["parallel_art_correction"]
    assert got["out0"].shape == (N, N, N)
    assert rel_err(got["out0"], want["out0"]) <= TOL["tri"]
    for k in ("out1", "out2"):
        assert abs(float(got[k]) - want[k]) <= 1e-5 * abs(want[k])
    for k, v in _port_out(meshes, "parallel_art_correction", 2, 1).items():
        np.testing.assert_array_equal(v, got[k])


def test_reconstruct_art_mesh_dp_matches_serial_and_the_reference(meshes):
    _cli_report(meshes, "art_dp", 2)
    d = meshes["dir"]
    got = np.squeeze(Image(str(d / "art_mesh.vol")).data)
    for other in ("serial", "ref"):
        assert rel_err(got, np.squeeze(Image(str(
            d / f"art_{other}.vol")).data)) <= TOL["tri"]


def _col(rows, k):
    return np.array([r[k] for r in rows])


def _same_views(got, want):
    """Rows that assign the reference's direction and flip, where every
    row names that view or its exact tie (the antipodal direction with the
    other flip: the mirrored projection, which scores the same)."""
    view = lambda rs: directions_from_angles(np.stack(
        [_col(rs, "angleRot"), _col(rs, "angleTilt")], 1)) * \
        np.where(_col(rs, "flip") > 0, -1.0, 1.0)[:, None]
    assert [r["itemId"] for r in got] == [r["itemId"] for r in want]
    assert ((view(got) * view(want)).sum(-1) > 1 - 1e-6).all()
    return _col(got, "flip") == _col(want, "flip")


def test_align_significant_mesh_dp_matches_serial_and_the_reference(meshes):
    """The ranks score the serial run's --batch chunks: the rows and the
    updated references equal the serial port's. Against the reference's
    run on its virtual devices: every row names the reference's direction
    and flip, or the antipode with the other flip (>= 0.9 the same), and
    the values of those rows agree as tests/test_torch_cli_reconstruct_misc
    .py holds the serial run."""
    _cli_report(meshes, "asig_dp", 2)
    d = meshes["dir"]
    got, serial, want = (_rows(d / f"asig_{t}.xmd")
                         for t in ("mesh", "serial", "ref"))
    assert len(got) == 2 * B
    assert [list(r.items()) for r in got] == \
        [list(r.items()) for r in serial]
    np.testing.assert_array_equal(Image(str(d / "upd_mesh.stk")).data,
                                  Image(str(d / "upd_serial.stk")).data)
    same = _same_views(got, want)
    assert same.mean() >= 0.9
    for k, tol in (("shiftX", 1e-3), ("shiftY", 1e-3), ("maxCC", 1e-5),
                   ("weight", 2e-6)):      # the files keep 6 decimals
        assert np.abs(_col(got, k) - _col(want, k))[same].max() <= tol, k


def test_parallel_class_sums_match_serial_and_the_reference(meshes):
    """Each rank registers its half of the views and adds them into the
    class sums with index_add_; one all_reduce: every rank holds the
    serial sums and counts."""
    from xmipp3_tpu_torch.ops.geo import apply_md_geometry
    d = meshes["dir"]
    inp = dict(np.load(d / "w2" / "inputs.npz"))
    reg = apply_md_geometry(inp["imgs"], inp["psi"], inp["sx"], inp["sy"],
                            inp["flipf"] > 0.5, device="cpu").numpy()
    w = inp["selw"]
    serial = np.stack([(reg * (w * (inp["assign"] == k))[:, None, None])
                       .sum(0) for k in range(N_CLASSES)])
    counts = np.array([w[inp["assign"] == k].sum()
                       for k in range(N_CLASSES)])
    want_sums, want_counts = meshes["ref"]["class_sums"]
    for r in range(2):
        got = _port_out(meshes, "parallel_class_sums", 2, r)
        for want in (serial, want_sums):
            assert rel_err(got["out0"], want) <= 1e-5
        np.testing.assert_array_equal(got["out1"], counts)
        np.testing.assert_array_equal(got["out1"], want_counts)


def test_angular_class_average_mesh_dp_matches_serial(meshes):
    """--mesh dp --split on 2 ranks: the serial port's averages and halves
    (the ranks draw the serial path's halves, one permutation a class);
    the reference's averages. The reference's own mesh path draws its
    halves from one Bernoulli draw over all views, and its serial path one
    permutation a class, so its mesh halves differ from its serial ones
    (ROADMAP.md section 3, item 14)."""
    _cli_report(meshes, "classavg_dp", 2)
    d = meshes["dir"]
    stk = lambda t, s="": np.squeeze(Image(str(d / f"classavg_{t}{s}.stk"))
                                     .data)
    for s in ("", "_split1", "_split2"):
        assert rel_err(stk("mesh", s), stk("serial", s)) <= 1e-5, s
    assert [r["classCount"] for r in _rows(d / "classavg_mesh.xmd")] == \
        [r["classCount"] for r in _rows(d / "classavg_serial.xmd")]
    assert rel_err(stk("mesh"), stk("ref")) <= 1e-5
    assert rel_err(stk("mesh"), stk("refserial")) <= 1e-5
    assert rel_err(stk("mesh", "_split1"), stk("refserial", "_split1")) \
        <= 1e-5
    assert rel_err(stk("ref", "_split1"), stk("refserial", "_split1")) \
        > 1e-2


def test_reconstruct_significant_mesh_dp_matches_serial_and_reference(meshes):
    """The ranks score the serial run's chunks and grid the volume through
    parallel_reconstruct: the serial port's rows, equal, and its volume
    (1e-4); the reference's mesh run's views (weights 1e-4) and, since a
    tie that names the antipode draws its weight from another
    neighbourhood, its volume to a correlation of 0.99. A view is its
    direction and flip, or their exact tie."""
    _cli_report(meshes, "rsig_dp", 2)
    d = meshes["dir"]
    got, serial, want = (_rows(d / f"rsig_{t}" / "significant_images.xmd")
                         for t in ("mesh", "serial", "ref"))
    assert [list(r.items()) for r in got] == \
        [list(r.items()) for r in serial]
    same = _same_views(got, want)
    assert same.mean() >= 0.9
    assert np.abs(_col(got, "weight") - _col(want, "weight"))[
        same].max() <= 1e-4
    vol = lambda t: np.squeeze(Image(str(
        d / f"rsig_{t}" / "significant_volume.vol")).data)
    assert rel_err(vol("mesh"), vol("serial")) <= 1e-4
    a, b = (v - v.mean() for v in (vol("mesh"), vol("ref")))
    assert (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()) >= 0.99


def _cli_report(meshes, job, n):
    reps = meshes["reports"][n]
    for rep in reps:
        assert rep["jobs"][job].get("rc") == 0, (rep["rank"],
                                                 rep["jobs"][job])
    # only rank 0 writes files
    assert reps[0]["jobs"][job]["writes"] >= 1
    assert all(rep["jobs"][job]["writes"] == 0 for rep in reps[1:])


@pytest.mark.parametrize("mode", ["dp", "slab", "slab2d", "auto"])
def test_reconstruct_cli_mesh_matches_the_reference(meshes, mode):
    _cli_report(meshes, f"rec_{mode}", REC_MODES[mode])
    got = np.squeeze(Image(str(meshes["dir"] / f"rec_{mode}.vol")).data)
    # on its eight devices the reference resolves auto to dp
    want = meshes["ref"]["rec_" + ("dp" if mode == "auto" else mode)]
    assert got.shape == (N, N, N)
    assert rel_err(got, want) <= TOL["tri"]


def test_reconstruct_cli_mesh_slab_usectf_matches_the_reference(meshes,
                                                               tmp_path):
    """--mesh slab --useCTF on 2 ranks: every rank grids the CTF factors
    of every row into its slab; the volume is the reference's on its
    virtual mesh and the port's serial one."""
    _cli_report(meshes, "rec_slab_ctf", REC_MODES["slab_ctf"])
    d = meshes["dir"]
    got = np.squeeze(Image(str(d / "rec_slab_ctf.vol")).data)
    assert rel_err(got, meshes["ref"]["rec_slab_ctf"]) <= TOL["tri"]
    assert get_program("reconstruct_fourier").run_with_args(
        ["-i", str(d / "parts_ctf.xmd"), "-o", str(tmp_path / "s.vol"),
         "--interp", "tri", "--weight", "--device", "cpu", "-v", "0"]
        + CTF_FLAGS) == 0
    assert rel_err(got, np.squeeze(Image(str(tmp_path / "s.vol")).data)) \
        <= TOL["tri"]
    plain = np.squeeze(Image(str(d / "rec_slab.vol")).data)
    assert rel_err(got, plain) > 1e-2          # the CTF was corrected for


def test_reconstruct_cli_mesh_tp_raises_as_the_reference(meshes):
    """The reference's reconstruct_fourier --mesh tp hands its "model"
    mesh to parallel_reconstruct, which reads the "data" axis: KeyError,
    on every rank of the port too."""
    for rep in meshes["reports"][2]:
        assert rep["jobs"]["rec_tp"]["raised"] == "KeyError: 'data'"
        assert rep["jobs"]["rec_tp"]["writes"] == 0


@pytest.mark.parametrize("mode", list(MATCH_MODES))
def test_matching_cli_mesh_matches_the_reference(meshes, mode):
    _cli_report(meshes, f"match_{mode}", MATCH_MODES[mode])
    # the reference's auto and slab meshes run its dp matcher, as the
    # port's do (slab2d over the data axis of its 2-D mesh)
    want = meshes["ref"]["match_" + ("tp" if mode == "tp" else "dp")]
    _hold_rows(_rows(meshes["dir"] / f"match_{mode}.xmd"), want,
               meshes["gallery"])


def test_local_align_mesh_matches_serial_and_reference(meshes):
    serial, cys, cxs = meshes["ref"]["local_align"]
    want = meshes["ref"]["local_align_mesh"]
    got = _port_out(meshes, "local_align_mesh", 2)
    assert np.array_equal(got["out1"], cys) and \
        np.array_equal(got["out2"], cxs)
    assert got["out0"].shape == serial.shape == (3, 3, 6, 2)
    assert np.abs(got["out0"] - serial).max() <= 1e-3
    assert np.abs(got["out0"] - want[0]).max() <= 0.02
    np.testing.assert_array_equal(
        _port_out(meshes, "local_align_mesh", 2, 1)["out0"], got["out0"])


def test_movie_cli_mesh_dp_matches_the_serial_run(meshes):
    _cli_report(meshes, "movie_dp", 2)
    d = meshes["dir"]
    for stem in ("dp", "serial"):
        assert (d / f"movie_{stem}.mrc").exists()
    sh = [np.stack([MetaData(str(d / f"movie_{s}.xmd")).getColumn(c)
                    for c in ("shiftX", "shiftY")], 1)
          for s in ("dp", "serial")]
    np.testing.assert_array_equal(sh[0], sh[1])
    assert rel_err(np.squeeze(Image(str(d / "movie_dp.mrc")).data),
                   np.squeeze(Image(str(d / "movie_serial.mrc")).data)) \
        <= 1e-4


# -- one rank, no process group ----------------------------------------------

def test_mesh_auto_on_one_rank_is_the_serial_path(meshes, tmp_path):
    d = meshes["dir"]
    assert resolve_mesh("auto", device="cpu") == (None, "none")
    out = tmp_path / "rec.vol"
    assert get_program("reconstruct_fourier").run_with_args(
        ["-i", str(d / "parts.xmd"), "-o", str(out), "--interp", "tri",
         "--weight", "--device", "cpu", "--mesh", "auto", "-v", "0"]) == 0
    assert rel_err(np.squeeze(Image(str(out)).data),
                   meshes["ref"]["rec_dp"]) <= TOL["tri"]
    out = tmp_path / "a.xmd"
    assert get_program("angular_projection_matching").run_with_args(
        ["-i", str(d / "views.xmd"), "-o", str(out), "--ref",
         str(d / "port"), "--max_shift", "4", "--device", "cpu", "-v",
         "0"]) == 0                        # --mesh left at its default
    _hold_rows(_rows(out), meshes["ref"]["match_dp"], meshes["gallery"])


@pytest.mark.parametrize("program", ["reconstruct_fourier",
                                     "angular_projection_matching"])
@pytest.mark.parametrize("mode", ["dp", "tp", "slab", "slab2d"])
def test_mesh_modes_on_one_rank_raise(tmp_path, program, mode):
    args = {"reconstruct_fourier": ["-i", "p.xmd", "-o",
                                    str(tmp_path / "r.vol")],
            "angular_projection_matching": ["-i", "p.xmd", "-o",
                                            str(tmp_path / "a.xmd"),
                                            "--ref", "g"]}[program]
    with pytest.raises(RuntimeError, match=f"--mesh {mode} needs >= 2 "
                       "devices, found 1"):
        get_program(program).run_with_args(
            args + ["--device", "cpu", "--mesh", mode])
    assert not list(tmp_path.iterdir())


def test_resolve_mesh_modes():
    with pytest.raises(ValueError, match="expected one of"):
        resolve_mesh("ring")
    for mode in ("none", "serial", "auto"):
        assert resolve_mesh(mode) == (None, "none")


def test_parallel_pca_components_match_serial_and_the_reference(meshes):
    from xmipp3_tpu_torch.models.dimred import pca
    X = dict(np.load(meshes["dir"] / "w2" / "inputs.npz"))["pca_X"]
    _, model = pca(X, d=4, return_model=True, device="cpu")
    for r in range(2):
        got = _port_out(meshes, "parallel_pca_components", 2, r)["vol"]
        assert got.shape == (4, 64)
        for want in (model["components"], meshes["ref"]["pca"]):
            s = np.sign((got * want).sum(axis=1))[:, None]
            assert rel_err(s * got, want) <= 1e-4


def test_parallel_filter_bank_matches_serial_and_the_reference(meshes):
    from xmipp3_tpu_torch.ops import halves_restoration as thr
    inp = dict(np.load(meshes["dir"] / "w2" / "inputs.npz"))
    serial = thr.filter_bank(*(torch.as_tensor(inp[k]) for k in BANK["args"]),
                             **dict(BANK_KW, shape=(HN,) * 3))
    for r in range(2):
        got = _port_out(meshes, "parallel_filter_bank", 2, r)
        for i, want in enumerate(serial):
            assert rel_err(got[f"out{i}"], want) <= 1e-5
            assert rel_err(got[f"out{i}"], meshes["ref"]["bank"][i]) <= 5e-5


def _principal_angles(A, B):
    qa = np.linalg.qr(A.reshape(len(A), -1).T)[0]
    qb = np.linalg.qr(B.reshape(len(B), -1).T)[0]
    return np.arccos(np.clip(np.linalg.svd(qa.T @ qb, compute_uv=False),
                             -1, 1))


def test_image_rotational_pca_mesh_dp_matches_serial(meshes):
    _cli_report(meshes, "rpca_dp", 2)
    d = meshes["dir"]
    basis = lambda t: np.squeeze(Image(str(d / f"rpca_{t}.stk")).data)
    for other in ("serial", "ref"):
        assert _principal_angles(basis("mesh"), basis(other)).max() <= 1e-3


def test_volume_halves_restoration_mesh_dp_matches_serial(meshes):
    _cli_report(meshes, "halves_dp", 2)
    d = meshes["dir"]
    v = lambda t, f: np.squeeze(Image(str(d / f"halves_{t}_{f}.vol")).data)
    for f in ("filterBank", "restored1", "restored2", "avgDiff"):
        assert rel_err(v("mesh", f), v("serial", f)) <= 1e-5, f
        assert rel_err(v("mesh", f), v("ref", f)) <= 5e-5, f
