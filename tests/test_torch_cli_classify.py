"""The classification programs of the port against the reference package's
programs on the same files, on the CPU (N=32):

- classify_CL2D (--nref0 2 --nref 4): the same _images.xmd columns (ref,
  flip, enabled equal; psi, shifts, maxCC as test_torch_cl2d.py holds the
  model: within 0.05 degrees, 0.01 px, 1e-4), references <= 1e-3 * max,
  and the same level_%02d blocks with the same members;
- classify_CL2D_core_analysis --computeCore 3 2 and --computeStableCore 1
  on each package's CL2D directory: the same blocks and members;
- ml_align2d (--mirror) and mlf_align2d (inline ctf* labels in 2 defocus
  groups, --sampling_rate 2, so its Wiener pre-correction runs; --kstest):
  the same classes and flips, references <= 1e-3 * max (mlf_align2d
  1e-2: the reference's own references move by 3.8e-3 of their max when
  its input moves by the 3e-7 that separates the two packages' Wiener
  corrections; a near tie of the top-K poses), weights <= 1e-4,
  the KS statistics <= 1e-2, and the final log-likelihood per image
  within 0.02. That is a difference of terms of order 10^2 (d_eff = 104
  rings x angles at N=32) and near zero here; the reference's float32
  residual moment (2e-4 relative, test_torch_ml2d.py) moves sigma and with
  it the log-likelihood by up to 0.014 after 3 iterations (read 0.0136 for
  mlf_align2d, where the two packages' Wiener-corrected inputs agree to
  3e-7);
- classify_kerdensom on classificationData vectors (kerdensom, som,
  batch_som, fuzzy_som; --reg0 10 --regF 1: at the default 1000 -> 100
  this data's map collapses to equal code vectors, and every argmin is a
  tie that roundoff decides): the same ref column and code book <= 1e-4;
- angular_accuracy_pca against a reprojected volume, with --i2 and with
  --dim: scoreByPcaResidual <= 1e-4;
- the 18 aliases of the reference's registry that name these and the
  earlier programs dispatch to the class of their program.
"""
import numpy as np
import pytest
import torch

from test_classify import two_class_stack
from test_torch_common import rel_err
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

CTF = dict(ctfVoltage=300.0, ctfSphericalAberration=2.7, ctfQ0=0.1,
           ctfDefocusAngle=20.0)


def both(name, args_of, device=True):
    """Run `name` through both dispatchers; args_of(tag) gives each run's
    arguments ("j" for the reference, "t" for the port)."""
    assert jax_program(name).run_with_args(args_of("j") + ["-v", "0"]) == 0
    tail = ["--device", "cpu", "-v", "0"]
    assert get_program(name).run_with_args(args_of("t") + tail) == 0


def rows(fn, block=None):
    md = MetaData(fn, block=block)
    return [md.getRow(i) for i in md]


def hold_rows(got, want, exact=(), close=()):
    assert len(got) == len(want)
    for k in exact:
        assert [r[k] for r in got] == [r[k] for r in want], k
    for k, tol in close:
        a = np.array([r[k] for r in got], np.float64)
        b = np.array([r[k] for r in want], np.float64)
        assert np.abs(a - b).max() <= tol, k


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    d = tmp_path_factory.mktemp("classify")
    imgs, labels = two_class_stack(n_per=12, size=32)
    save_image(str(d / "parts.mrcs"), imgs)
    return d


def _psi_close(got, want):
    d = (np.array([r["anglePsi"] for r in got])
         - np.array([r["anglePsi"] for r in want]) + 180.0) % 360.0 - 180.0
    assert np.abs(d).max() <= 0.05


@pytest.fixture(scope="module")
def cl2d(stack):
    for t in "jt":
        (stack / f"cl2d_{t}").mkdir()
    both("classify_CL2D", lambda t: [
        "-i", str(stack / "parts.mrcs"), "--odir", str(stack / f"cl2d_{t}"),
        "--oroot", "cl", "--nref", "4", "--nref0", "2", "--iter", "4",
        "--maxShift", "4"])
    return stack


def test_classify_cl2d_matches_the_reference(cl2d):
    j, t = cl2d / "cl2d_j", cl2d / "cl2d_t"
    got, want = rows(str(t / "cl_images.xmd")), rows(str(j / "cl_images.xmd"))
    hold_rows(got, want, exact=("image", "ref", "flip", "enabled"),
              close=(("shiftX", 0.01), ("shiftY", 0.01), ("maxCC", 1e-4)))
    _psi_close(got, want)
    assert rel_err(Image.read_stack(str(t / "cl_references.stk")),
                   Image.read_stack(str(j / "cl_references.stk"))) <= 1e-3
    hold_rows(rows(str(t / "cl_classes.xmd")),
              rows(str(j / "cl_classes.xmd")), exact=("ref", "classCount"))
    for lev in ("level_00", "level_01"):
        fj, ft = str(j / lev / "cl_classes.xmd"), str(t / lev /
                                                      "cl_classes.xmd")
        assert MetaData.blocksInFile(ft) == MetaData.blocksInFile(fj)
        for blk in MetaData.blocksInFile(fj):
            hold_rows(rows(ft, blk), rows(fj, blk),
                      exact=("ref",) + (("image", "flip")
                                        if blk != "classes" else
                                        ("classCount",)))


def test_core_analysis_matches_the_reference(cl2d):
    for flags in (["--computeCore", "3", "2"], ["--computeStableCore", "0"]):
        both("classify_CL2D_core_analysis", lambda t: [
            "--dir", str(cl2d / f"cl2d_{t}"), "--root", "cl", *flags])
    for lev, suffix in (("level_00", "_core"), ("level_01", "_core"),
                        ("level_01", "_stable_core")):
        fj = str(cl2d / "cl2d_j" / lev / f"cl_classes{suffix}.xmd")
        ft = str(cl2d / "cl2d_t" / lev / f"cl_classes{suffix}.xmd")
        assert MetaData.blocksInFile(ft) == MetaData.blocksInFile(fj)
        for blk in MetaData.blocksInFile(fj):
            hold_rows(rows(ft, blk), rows(fj, blk),
                      exact=("ref", "classCount") if blk == "classes"
                      else ("image", "ref"))


def test_core_analysis_without_a_mode_raises(cl2d):
    from xmipp3_tpu_torch.core.errors import XmippError
    prog = get_program("classify_CL2D_core_analysis")
    with pytest.raises(XmippError):
        prog.read(["xmipp_classify_CL2D_core_analysis", "--dir",
                   str(cl2d / "cl2d_t"), "--root", "cl", "--device", "cpu"])
        prog.run()


@pytest.mark.parametrize("program,extra", [
    ("ml_align2d", ["--mirror"]),
    ("mlf_align2d", ["--sampling_rate", "2", "--kstest"])])
def test_ml_programs_match_the_reference(stack, program, extra):
    fn = str(stack / f"{program}.xmd")
    imgs = Image.read_stack(str(stack / "parts.mrcs"))
    MetaData.fromRows(
        dict(CTF, image=f"{i + 1:06d}@{stack / 'parts.mrcs'}", itemId=i + 1,
             ctfDefocusU=12000.0 + 4000.0 * (i % 2),
             ctfDefocusV=12300.0 + 4000.0 * (i % 2))
        for i in range(len(imgs))).write(fn)
    both(program, lambda t: ["-i", fn, "--nref", "2", "--iter", "3",
                             "--maxShift", "2", "--oroot",
                             str(stack / f"{program}_{t}"), *extra])
    j, t = (str(stack / f"{program}_{s}") for s in "jt")
    hold_rows(rows(t + "_images.xmd"), rows(j + "_images.xmd"),
              exact=("image", "ref", "flip"),
              close=(("logLikelihood", 0.02),))
    assert rel_err(Image.read_stack(t + "_references.stk"),
                   Image.read_stack(j + "_references.stk")) <= \
        (1e-3 if program == "ml_align2d" else 1e-2)
    if program == "ml_align2d":
        hold_rows(rows(t + "_classes.xmd"), rows(j + "_classes.xmd"),
                  exact=("ref",), close=(("weight", 1e-4),))
    else:
        hold_rows(rows(t + "_kstest.xmd"), rows(j + "_kstest.xmd"),
                  exact=("itemId",), close=(("weight", 1e-2),))


@pytest.mark.parametrize("variant", ["kerdensom", "som", "batch_som",
                                     "fuzzy_som"])
def test_kerdensom_matches_the_reference(tmp_path, variant):
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.normal(0, 0.5, (30, 6)),
                        rng.normal(2, 0.5, (30, 6))])
    fn = str(tmp_path / "vectors.xmd")
    MetaData.fromRows({"itemId": i + 1, "classificationData": list(v)}
                      for i, v in enumerate(X)).write(fn)
    both("classify_kerdensom", lambda t: [
        "-i", fn, "--oroot", str(tmp_path / f"som_{t}"), "--xdim", "3",
        "--ydim", "2", "--iter", "30", "--variant", variant, "--norm",
        "--reg0", "10", "--regF", "1"])
    hold_rows(rows(str(tmp_path / "som_t_images.xmd")),
              rows(str(tmp_path / "som_j_images.xmd")),
              exact=("itemId", "ref"))
    assert rel_err(np.load(tmp_path / "som_t_codebook.npy"),
                   np.load(tmp_path / "som_j_codebook.npy")) <= 1e-4


@pytest.fixture(scope="module")
def accuracy(tmp_path_factory):
    """A phantom, 24 of its projections at known poses (psi and shifts
    undone by the rows' registration) with noise; 4 rows' rot moved by
    15 degrees."""
    from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
    from xmipp3_tpu_torch.ops.project import FourierProjector
    d = tmp_path_factory.mktemp("accuracy")
    vol = phantom8(32)
    save_image(str(d / "vol.vol"), vol)
    rng = np.random.default_rng(5)
    n = 24
    rot = rng.uniform(0, 360, n).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, n))).astype(np.float32)
    proj = FourierProjector(vol, device="cpu").project_euler(
        rot, tilt, np.zeros(n, np.float32))
    imgs = proj.numpy() + 0.05 * rng.standard_normal(proj.shape).astype(
        np.float32)
    save_image(str(d / "parts.mrcs"), imgs)
    save_image(str(d / "nb.mrcs"), proj.numpy()[:20])
    rot[:4] += 15.0
    MetaData.fromRows(
        {"image": f"{i + 1:06d}@{d / 'parts.mrcs'}", "angleRot": float(r),
         "angleTilt": float(t), "anglePsi": 0.0, "shiftX": 0.0,
         "shiftY": 0.0, "flip": 0}
        for i, (r, t) in enumerate(zip(rot, tilt))).write(str(d / "p.xmd"))
    MetaData.fromRows({"image": f"{i + 1:06d}@{d / 'nb.mrcs'}"}
                      for i in range(20)).write(str(d / "nb.xmd"))
    return d


@pytest.mark.parametrize("extra", [[], ["--dim", "24"],
                                   ["--i2", "nb.xmd"]],
                         ids=["reproject", "dim", "i2"])
def test_angular_accuracy_pca_matches_the_reference(accuracy, extra):
    extra = [str(accuracy / e) if e.endswith(".xmd") else e for e in extra]
    both("angular_accuracy_pca", lambda t: [
        "-i", str(accuracy / "p.xmd"), "--ref", str(accuracy / "vol.vol"),
        "-o", str(accuracy / f"out_{t}.xmd"), *extra])
    got = rows(str(accuracy / "out_t.xmd"))
    want = rows(str(accuracy / "out_j.xmd"))
    hold_rows(got, want, exact=("image",),
              close=(("scoreByPcaResidual", 1e-4),))


SERIAL = {"classify_CL2D", "ml_align2d", "mlf_align2d",
          "classify_CL2D_core_analysis", "angular_accuracy_pca"}


@pytest.mark.parametrize("alias", sorted(set(ALIASES) - {
    "ctf_correct_phase", "cuda_movie_alignment_correlation"}))
def test_alias_dispatches_to_its_program(alias):
    name = ALIASES[alias]
    assert type(get_program(alias)) is type(get_program(name))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__
    if alias.startswith("mpi_") and alias[4:] in SERIAL:
        assert alias[4:] == name


def test_eighteen_aliases_and_six_programs_are_registered():
    from xmipp3_tpu_torch.programs import list_programs
    names = set(list_programs())
    assert SERIAL | {"classify_kerdensom"} <= names
    later = {"mpi_image_operate", "mpi_image_resize",
             "mpi_transform_threshold", "mpi_reconstruct_art",
             "mpi_reconstruct_wbp", "mpi_reconstruct_significant",
             "cuda_align_significant"}    # tests/test_torch_cli_utils.py
    import test_torch_cli_analysis as analysis
    import test_torch_cli_angular as angular
    import test_torch_cli_flex as flex
    import test_torch_cli_flex_tail as flex_tail
    import test_torch_cli_misc as misc
    import test_torch_cli_tail as tail
    import test_torch_cli_tomo as tomo
    import test_torch_cli_volume as volume
    later |= set().union(*(set(m.NEW_ALIASES)
                           for m in (angular, analysis, misc, volume,
                                     flex, flex_tail, tomo, tail)))
    assert len(set(ALIASES) - {"ctf_correct_phase",
                               "cuda_movie_alignment_correlation"}
               - later) == 18


@pytest.mark.parametrize("name,args", [
    ("classify_CL2D", ["-i", "x.mrcs"]), ("ml_align2d", ["-i", "x.mrcs"]),
    ("mlf_align2d", ["-i", "x.mrcs"]), ("classify_kerdensom", ["-i", "x.xmd"]),
    ("classify_CL2D_core_analysis",
     ["--dir", "d", "--root", "r", "--computeStableCore", "1"]),
    ("angular_accuracy_pca", ["-i", "x.xmd", "--ref", "v.vol"])],
    ids=lambda v: v if isinstance(v, str) else "")
def test_programs_without_a_card_raise(monkeypatch, name, args):
    """Without --device cpu each program asks for the card before it reads
    anything, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = get_program(name)
    prog.read(["xmipp_" + name, *args])
    with pytest.raises(RuntimeError, match="--device cpu"):
        prog.run()
