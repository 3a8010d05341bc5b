"""The movie programs of the port (phantom_movie, movie_alignment_correlation
and its alias cuda_movie_alignment_correlation, movie_filter_dose,
movie_estimate_gain) against the reference's programs on the same files,
the port with --device cpu.

The movie is tests/test_final_batch.py:55's recipe, phantom_movie -size 128
128 6 --simple --shift 2 0 -1 0 --skipBarrel --skipDose --step 32 32
--thickness 2 --signal 2 --seed 1, and the same with ice and barrel
distortion. Held to: phantom frames without dose value for value (1e-5 of
the max), dosed frames by mean and variance (3 % and 5 %: torch's Poisson
draws are not numpy's), the ground truth exactly; frame shifts within
0.02 px of the reference's and 0.5 px of the truth; averages and kept
stacks 1e-4 of the max; dose-filtered stacks 1e-4 of the max; gains 1e-6
relative.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.errors import XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)
SIDES = (("ref", jax_program, []), ("port", get_program, ["--device", "cpu"]))
SIMPLE = ("-size 128 128 6 --simple --shift 2 0 -1 0 --skipBarrel "
          "--skipDose --step 32 32 --thickness 2 --signal 2 --seed 1")
SHIFT_TOL = 0.02


def run(prog, name, args, extra=()):
    args = args.split() if isinstance(args, str) else list(args)
    p = prog(name)
    assert p.run_with_args(args + ["-v", "0", *extra]) == 0
    return p


def both(name, args_of, d):
    """Run `name` on each side with args_of(side) (a string or list);
    return the two program objects."""
    return {side: run(prog, name, args_of(side), extra)
            for side, prog, extra in SIDES}


def load(fn):
    return np.squeeze(Image(str(fn)).data)


def shifts(fn):
    md = MetaData(str(fn))
    return np.stack([md.getColumn("shiftX"), md.getColumn("shiftY")], axis=1)


@pytest.fixture(scope="module")
def movies(tmp_path_factory):
    """Each side's phantom movies: the simple recipe, the same with ice and
    barrel distortion, and a dosed one."""
    d = tmp_path_factory.mktemp("movies")
    recipes = {"simple": SIMPLE,
               "ice": "-size 128 128 6 --skipDose --seed 3 --step 24 24",
               "dose": "-size 96 96 4 --seed 2 --dose 30 --type circle "
                       "--count 6 --particleSize 12 16 --thickness 2"}
    for key, recipe in recipes.items():
        both("phantom_movie", lambda side: f"-o {d}/{key}_{side}.mrcs "
             f"{recipe} --gain {d}/{key}_{side}_gain.xmp", d)
    return d


@pytest.mark.parametrize("key", ["simple", "ice"])
def test_phantom_movie_without_dose_matches(movies, key):
    ref, port = (load(movies / f"{key}_{s}.mrcs") for s in ("ref", "port"))
    assert port.shape == ref.shape == (6, 128, 128)
    assert rel_err(port, ref) <= 1e-5
    for s in ("ref", "port"):
        assert np.array_equal(load(movies / f"{key}_{s}_gain.xmp"),
                              np.ones((128, 128), np.float32))
    gt = [shifts(movies / f"{key}_{s}_gt.xmd") for s in ("ref", "port")]
    assert np.array_equal(gt[0], gt[1])


def test_phantom_movie_dose_matches_in_distribution(movies):
    ref, port = (load(movies / f"dose_{s}.mrcs") for s in ("ref", "port"))
    assert port.shape == ref.shape
    assert np.array_equal(port, np.round(port)) and port.min() >= 0
    assert abs(port.mean() - ref.mean()) <= 0.03 * ref.mean()
    assert abs(port.var() - ref.var()) <= 0.05 * ref.var()


ALIGN_CASES = {
    "global": "--skipLocalAlignment --oaligned {d}/al_{s}.mrcs",
    "local": "--oavgInitial {d}/avg0_{s}.mrc",
    "local_avg1_minres": "--patchesAvg 1 --minLocalRes 80 --patches 3 3",
    "ranges_dose": "--skipLocalAlignment --frameRange 1 5 --frameRangeSum "
                   "2 4 --dose_per_frame 1.5 --voltage 200",
    "bin_maxres": "--bin 2 --maxResForCorrelation 8 --skipLocalAlignment",
    "dark_gain": "--dark {d}/dark.mrc --gain {d}/gain.mrc "
                 "--skipLocalAlignment",
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_movie_alignment_matches(movies, case, tmp_path):
    d = tmp_path
    rng = np.random.default_rng(4)
    save_image(str(d / "dark.mrc"),
               rng.uniform(0, 0.1, (128, 128)).astype(np.float32))
    save_image(str(d / "gain.mrc"),
               rng.uniform(0.9, 1.1, (128, 128)).astype(np.float32))
    movie = movies / "simple_ref.mrcs"
    progs = {}
    for side, prog, extra in SIDES:
        name = ("cuda_movie_alignment_correlation" if side == "port"
                and case == "global" else "movie_alignment_correlation")
        args = (f"-i {movie} -o {d}/sh_{side}.xmd --oavg {d}/avg_{side}.mrc "
                f"--maxShift 30 --sampling 1 "
                + ALIGN_CASES[case].format(d=d, s=side))
        progs[side] = run(prog, name, args, extra)
    got, want = shifts(d / "sh_port.xmd"), shifts(d / "sh_ref.xmd")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= SHIFT_TOL
    if case in ("global", "local"):
        true = shifts(movies / "simple_ref_gt.xmd")
        assert np.abs(got - (true - true.mean(axis=0))).max() < 0.5
    for stem in ("avg", "avg0", "al"):
        if (d / f"{stem}_ref.mrc").exists() or \
                (d / f"{stem}_ref.mrcs").exists():
            ext = ".mrcs" if stem == "al" else ".mrc"
            assert rel_err(load(d / f"{stem}_port{ext}"),
                           load(d / f"{stem}_ref{ext}")) <= 1e-4, stem
    if case.startswith("local"):
        assert np.abs(progs["port"].field
                      - _reference_field(movie, ALIGN_CASES[case])).max() \
            <= SHIFT_TOL


def _reference_field(movie, flags):
    """The reference's local field for the same movie and flags, through
    its ops (its program keeps no field)."""
    from xmipp3_tpu.ops import movie as jm
    frames = Image.read_stack(str(movie))
    pos = jm.global_align(frames, 30)
    avg = 1 if "--patchesAvg 1" in flags else 3
    patches = (3, 3) if "--patches 3 3" in flags else (7, 7)
    size = 80 if "--minLocalRes 80" in flags else 256
    return jm.local_align(frames, pos, patches=patches, patch_size=size,
                          max_shift_px=8, patches_avg=avg)[0]


def test_movie_alignment_refuses_a_sum_outside_the_range(movies, tmp_path):
    p = get_program("movie_alignment_correlation")
    p.read(["x", "-i", str(movies / "simple_ref.mrcs"), "-o",
            str(tmp_path / "o.xmd"), "--frameRange", "1", "3",
            "--frameRangeSum", "0", "3", "--device", "cpu"])
    with pytest.raises(XmippError, match="not aligned"):
        p.run()


@pytest.mark.parametrize("flags", ["--sampling 1.5 --dosePerFrame 3",
                                   "--frameRange 1 4 --pre_dose 2 "
                                   "--voltage 200"])
def test_movie_filter_dose_matches(movies, tmp_path, flags):
    movie = movies / "ice_ref.mrcs"
    both("movie_filter_dose",
         lambda s: f"-i {movie} -o {tmp_path}/f_{s}.mrcs {flags}", tmp_path)
    got, want = (load(tmp_path / f"f_{s}.mrcs") for s in ("port", "ref"))
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-4


def _gain_movie(d):
    """Poisson frames of a flat scene times a smooth column/row gain."""
    rng = np.random.default_rng(6)
    H, W = 48, 64
    g = (1 + 0.2 * np.sin(np.arange(W) / 5.0))[None, :] * \
        (1 + 0.1 * np.cos(np.arange(H) / 7.0))[:, None]
    fn = str(d / "g.mrcs")
    save_image(fn, rng.poisson(25.0 * g, (4, H, W)).astype(np.float32))
    return fn


@pytest.mark.parametrize("flags", ["--iter 2", "--iter 1 --sigma 1 "
                                   "--frameStep 2 --singleRef",
                                   "--iter 1 --gainImage {g}"])
def test_movie_estimate_gain_matches(tmp_path, flags):
    fn = _gain_movie(tmp_path)
    g0 = str(tmp_path / "g0.xmp")
    save_image(g0, np.random.default_rng(1).uniform(
        0.9, 1.1, (48, 64)).astype(np.float32))
    progs = both("movie_estimate_gain",
                 lambda s: f"-i {fn} --oroot {tmp_path}/{s} "
                 + flags.format(g=g0), tmp_path)
    assert rel_err(progs["port"].gain, progs["ref"].gain) <= 1e-6
    for stem in ("_gain.xmp", ".xmp"):
        assert np.array_equal(load(tmp_path / f"port{stem}"),
                              progs["port"].gain)


def test_movie_apply_gain_matches(tmp_path):
    fn = _gain_movie(tmp_path)
    g0 = str(tmp_path / "g0.xmp")
    save_image(g0, np.random.default_rng(1).uniform(
        0.9, 1.1, (48, 64)).astype(np.float32))
    both("movie_estimate_gain", lambda s: f"-i {fn} --gainImage {g0} "
         f"--applyGain {tmp_path}/ap_{s}.mrcs", tmp_path)
    assert rel_err(load(tmp_path / "ap_port.mrcs"),
                   load(tmp_path / "ap_ref.mrcs")) <= 1e-6


@pytest.mark.parametrize("name,args", [
    ("phantom_movie", "-o {d}/m.mrcs -size 64 64 2"),
    ("movie_alignment_correlation", "-i {m} -o {d}/s.xmd --oavg {d}/a.mrc"),
    ("movie_filter_dose", "-i {m} -o {d}/f.mrcs"),
    ("movie_estimate_gain", "-i {m} --oroot {d}/g")])
def test_movie_programs_without_a_card_raise(monkeypatch, movies, tmp_path,
                                             name, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = args.format(d=tmp_path, m=movies / "simple_ref.mrcs").split()
    with pytest.raises(RuntimeError, match="--device cpu"):
        get_program(name).run_with_args(argv)
    assert not list(tmp_path.iterdir())


def test_dose_on_non_square_frames_runs_where_the_reference_raises(tmp_path):
    """The reference builds (H, H//2+1) dose weights for (H, W//2+1)
    spectra and raises on non-square frames (ROADMAP.md section 3); the
    port weights each frame at its own shape, as numpy does here."""
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((3, 64, 96)).astype(np.float32)
    fn = str(tmp_path / "m.mrcs")
    save_image(fn, frames)
    with pytest.raises(TypeError, match="broadcasting"):
        jax_program("movie_filter_dose").run_with_args(
            ["-i", fn, "-o", str(tmp_path / "r.mrcs"), "-v", "0"])
    run(get_program, "movie_filter_dose",
        f"-i {fn} -o {tmp_path}/p.mrcs --dosePerFrame 2 --sampling 1.5",
        ["--device", "cpu"])
    k = np.maximum(np.sqrt(np.fft.fftfreq(64)[:, None] ** 2
                           + np.fft.rfftfreq(96)[None, :] ** 2) / 1.5, 1e-6)
    nc = 0.24499 * k ** -1.6649 + 2.8141
    want = np.stack([np.fft.irfft2(np.fft.rfft2(f) * np.exp(
        -2.0 * (t + 1) / (2 * nc)), s=f.shape) for t, f in enumerate(frames)])
    assert rel_err(load(tmp_path / "p.mrcs"), want) <= 1e-5
    run(get_program, "movie_alignment_correlation",
        f"-i {fn} -o {tmp_path}/s.xmd --skipLocalAlignment --dose_per_frame 1"
        f" --oavg {tmp_path}/a.mrc", ["--device", "cpu"])
    assert load(tmp_path / "a.mrc").shape == (64, 96)
