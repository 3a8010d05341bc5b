"""The slice as a whole: the port's eight PSD and CTF-estimation programs
against the reference's on the same files, the port with --device cpu.

The micrograph is 384 x 384 at 2 A/px: complex white noise times a planted
CTF (defocus 12,000 / 10,500 A at 40 degrees, with its envelope) plus the
reference's background model, transformed back. Programs run with
--pieceDim 128 (PSDs of n=128).

Held to: PSD images (.psd, .psdstk, psd_estimate, the ARMA PSD) to 1e-5 of
the max; .ctfparam / .xmd files with the same labels and rows, every
fitted defocus within 1 % of the reference's; the micrograph's PSD-PCA
stdQ to 1e-4 of itself; enhanced PSDs to 1e-5 of the max; ctf_sort_psds'
criteria (on the same model and PSD files) to 1e-4 of each value or 1e-6
absolute; the programs' own flags of the reference's flag surface
(--Nsubpiece, --psd_estimator ARMA, --acceleration1D,
--downSamplingPerformed, --fastDefocus with --radial_noise,
--ctf_similar_to with --noDefocus) to the same tolerances; ctf_group's
groups exactly and its filter stacks to 1e-5 of the max; the regions mode under --mesh dp over two gloo ranks against the
serial port (1e-4) and against the reference's --mesh dp (1 %), with only
rank 0 writing. Flags that the reference accepts and ignores raise here
(ROADMAP §3 item 6).
"""
import numpy as np
import pytest
import torch

from test_torch_common import SYNTH_CTF, Ranks, rel_err
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.errors import XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.ctf import CTFDescription
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)
TS, SIZE, PIECE = 2.0, 384, 128
TRUTH = dict(defocusU=12000.0, defocusV=10500.0, azimuthal_angle=40.0)
FIT = ["--sampling_rate", str(TS), "--kV", "300", "--Cs", "2.7",
       "--Q0", "0.07"]
SIDES = (("ref", jax_program, []), ("port", get_program, ["--device", "cpu"]))
POSITIONS = [(70, 80), (200, 190), (310, 60), (150, 320), (330, 330)]


def plant_micrograph(n, Ts, seed):
    """Complex white noise times the CTF (envelope included) plus the
    background model's power, in Fourier space, transformed back."""
    ctf = CTFDescription(sampling_rate=Ts, **TRUTH, **SYNTH_CTF)
    fy = np.fft.fftfreq(n)[:, None] / Ts
    fx = np.fft.rfftfreq(n)[None, :] / Ts
    c = ctf.pure_at(fx, fy, device="cpu").numpy().astype(np.float64)
    bg = ctf.noise_at(fx, fy, device="cpu").numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    z = lambda: rng.standard_normal(c.shape) + 1j * rng.standard_normal(
        c.shape)
    spec = z() * c + z() * np.sqrt(np.maximum(bg, 0))
    return (np.fft.irfft2(spec, s=(n, n)) * n).astype(np.float32)


def _rows(fn):
    md = MetaData(str(fn))
    return [md.getRow(i) for i in md]


def _img(fn):
    return np.squeeze(Image(str(fn)).data)


def _run(prog, argv):
    assert prog.run_with_args(argv + ["-v", "0"]) == 0, argv


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The micrograph, its particle positions, a small micrograph for the
    ARMA program and a ctfdat of ten CTFs, each on two images."""
    d = tmp_path_factory.mktemp("ctfest")
    save_image(str(d / "mic.mrc"), plant_micrograph(SIZE, TS, 1))
    save_image(str(d / "small.mrc"), plant_micrograph(96, TS, 2))
    MetaData.fromRows({"xcoor": x, "ycoor": y} for x, y in POSITIONS) \
        .write(str(d / "pos.xmd"))
    rows = []
    for k in range(20):
        u = 8000.0 + 1300.0 * (k // 2)
        rows.append({"image": f"{k + 1:06d}@stack.mrcs",
                     "ctfDefocusU": u, "ctfDefocusV": u + 300.0,
                     "ctfDefocusAngle": 18.0 * (k // 2),
                     "ctfSamplingRate": TS, "ctfVoltage": 300.0,
                     "ctfSphericalAberration": 2.7, "ctfQ0": 0.07})
    MetaData.fromRows(rows).write(str(d / "ctfdat.xmd"))
    return d


@pytest.fixture(scope="module")
def runs(work):
    """Every program on both sides, once: {name: {side: output root}}."""
    d = work
    out = {}
    for side, prog, dev in SIDES:
        o = lambda name: str(d / f"{side}_{name}")
        mic = ["--micrograph", str(d / "mic.mrc"), "--pieceDim", str(PIECE)]
        _run(prog("ctf_estimate_from_micrograph"),
             mic + ["--oroot", o("mic"), "--ctfmodelSize", "64",
                    "--bootstrapFit", "2"] + FIT + dev)
        _run(prog("ctf_estimate_from_micrograph"),
             mic + ["--oroot", o("reg"), "--mode", "regions",
                    "--skipBorders", "0"] + FIT + dev)
        _run(prog("ctf_estimate_from_micrograph"),
             mic + ["--oroot", o("par"), "--mode", "particles",
                    str(d / "pos.xmd")] + FIT + dev)
        # the same PSD file (the reference's) into both PSD programs
        psd = str(d / "ref_mic.psd")
        _run(prog("ctf_estimate_from_psd"),
             ["--psd", psd, "-o", o("fp.ctfparam"), "--ctfmodelSize", "64",
              "--downSamplingPerformed", "2"] + FIT + dev)
        _run(prog("ctf_estimate_from_psd_fast"),
             ["--psd", psd, "-o", o("fast.ctfparam")] + FIT + dev)
        _run(prog("psd_estimate"),
             ["-i", str(d / "mic.mrc"), "-o", o("pe.xmp"), "--patches",
              "96", "96"] + dev)
        _run(prog("ctf_estimate_psd_with_arma"),
             ["-i", str(d / "small.mrc"), "-o", o("arma.xmp"), "--pieceDim",
              "48"] + dev)
        _run(prog("ctf_enhance_psd"),
             ["-i", psd, "-o", o("enh.xmp")] + dev)
        MetaData.fromRows([{"micrograph": str(d / "mic.mrc"), "psd": psd,
                            "ctfModel": str(d / "ref_mic.ctfparam")}]) \
            .write(o("sort.xmd"))
        _run(prog("ctf_sort_psds"), ["-i", o("sort.xmd")] + dev)
        _run(prog("ctf_group"),
             ["--ctfdat", str(d / "ctfdat.xmd"), "--oroot", o("grp"),
              "--wiener", "--error", "0.5"] + dev)
        _run(prog("ctf_group"),
             ["--ctfdat", str(d / "ctfdat.xmd"), "--oroot", o("grps"),
              "--simple", "4"] + dev)
        out[side] = o
    return out


def _ctf_close(got: dict, want: dict, tol=0.01):
    assert set(got) == set(want)
    for lbl in ("ctfDefocusU", "ctfDefocusV"):
        assert abs(float(got[lbl]) - float(want[lbl])) <= \
            tol * abs(float(want[lbl])), (lbl, got[lbl], want[lbl])


def test_micrograph_mode_matches_the_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert rel_err(_img(port("mic.psd")), _img(ref("mic.psd"))) <= 1e-5
    got, want = _rows(port("mic.ctfparam"))[0], _rows(ref("mic.ctfparam"))[0]
    _ctf_close(got, want)
    for lbl, true in (("ctfDefocusU", TRUTH["defocusU"]),
                      ("ctfDefocusV", TRUTH["defocusV"])):
        assert abs(float(got[lbl]) - true) <= 0.02 * true
    assert abs(got["ctfCritPsdStdQ"] - want["ctfCritPsdStdQ"]) <= \
        1e-4 * abs(want["ctfCritPsdStdQ"])
    for suffix in ("_ctfmodel_quadrant.xmp", "_ctfmodel_halfplane.xmp"):
        g, w = _img(port("mic") + suffix), _img(ref("mic") + suffix)
        assert g.shape == w.shape == (64, 64)
        # the observed half (the model's half follows the fitted values)
        assert rel_err(g[32:], w[32:]) <= 1e-5
    g, w = _rows(port("mic_bootstrap.xmd")), _rows(ref("mic_bootstrap.xmd"))
    assert len(g) == len(w) == 2
    for a, b in zip(g, w):
        _ctf_close(a, b)


def test_regions_mode_matches_the_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert rel_err(_img(port("reg.psd")), _img(ref("reg.psd"))) <= 1e-5
    assert rel_err(_img(port("reg.psdstk")), _img(ref("reg.psdstk"))) <= 1e-5
    g, w = _rows(port("reg_regions.xmd")), _rows(ref("reg_regions.xmd"))
    assert len(g) == len(w) == 9
    for a, b in zip(g, w):
        assert (a["xcoor"], a["ycoor"]) == (b["xcoor"], b["ycoor"])
        _ctf_close(a, b)
    _ctf_close(_rows(port("reg.ctfparam"))[0], _rows(ref("reg.ctfparam"))[0])


def test_particles_mode_matches_the_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert rel_err(_img(port("par.psdstk")), _img(ref("par.psdstk"))) <= 1e-5
    g, w = _rows(port("par_particles.xmd")), _rows(ref("par_particles.xmd"))
    assert len(g) == len(w) == len(POSITIONS)
    for a, b in zip(g, w):
        assert set(a) == set(b)
        _ctf_close(_rows(a["ctfModel"])[0], _rows(b["ctfModel"])[0])


def test_psd_programs_match_the_reference(runs):
    ref, port = runs["ref"], runs["port"]
    got = _rows(port("fp.ctfparam"))[0]
    _ctf_close(got, _rows(ref("fp.ctfparam"))[0])
    # --downSamplingPerformed 2: the model referred to the original sampling
    assert abs(got["ctfSamplingRate"] - TS / 2) < 1e-6
    got, want = _rows(port("fast.ctfparam"))[0], _rows(ref("fast.ctfparam"))[0]
    _ctf_close(got, want)
    assert got["ctfDefocusU"] == got["ctfDefocusV"]
    assert rel_err(_img(port("pe.xmp")), _img(ref("pe.xmp"))) <= 1e-5
    assert rel_err(_img(port("arma.xmp")), _img(ref("arma.xmp"))) <= 1e-5
    assert rel_err(_img(port("enh.xmp")), _img(ref("enh.xmp"))) <= 1e-5


def test_sort_psds_criteria_match_the_reference(runs):
    got = _rows(runs["port"]("sort.xmd"))[0]
    want = _rows(runs["ref"]("sort.xmd"))[0]
    assert set(got) == set(want)
    crits = [k for k in want if k.startswith("ctfCrit")]
    assert len(crits) >= 15
    for k in crits:
        assert abs(got[k] - want[k]) <= max(1e-4 * abs(want[k]), 1e-6), \
            (k, got[k], want[k])


@pytest.mark.parametrize("root", ["grp", "grps"])
def test_ctf_group_matches_the_reference(runs, root):
    ref, port = runs["ref"], runs["port"]
    g, w = _rows(port(root + ".xmd")), _rows(ref(root + ".xmd"))
    assert [r["defGroup"] for r in g] == [r["defGroup"] for r in w]
    assert len({r["defGroup"] for r in g}) > 1
    if root == "grp":
        for name in ("_ctf.mrcs", "_wien.mrcs"):
            assert rel_err(_img(port(root) + name), _img(ref(root) + name)) \
                <= 1e-5
        assert _rows(f"groups@{port(root)}Info.xmd") == \
            _rows(f"groups@{ref(root)}Info.xmd")


@pytest.fixture(scope="module")
def flag_runs(work, runs):
    """The programs' own flags of the reference's flag surface
    (tests/test_ctf_flag_surface.py), on both sides: {side: root}."""
    d = work
    out = {}
    CTFDescription(sampling_rate=TS, voltage=300, Cs=2.7, Q0=0.07,
                   defocusU=11500, defocusV=10000, azimuthal_angle=25.0) \
        .write(str(d / "seed.ctfparam"))
    psd = ["--psd", str(d / "ref_mic.psd")]
    for side, prog, dev in SIDES:
        o = lambda name: str(d / f"{side}_f_{name}")
        mic = ["--micrograph", str(d / "mic.mrc")]
        small = ["--micrograph", str(d / "small.mrc"), "--pieceDim", "64",
                 "--dont_estimate_ctf"]
        _run(prog("ctf_estimate_from_micrograph"),
             small + ["--oroot", o("sub"), "--Nsubpiece", "2"] + dev)
        _run(prog("ctf_estimate_from_micrograph"),
             small + ["--oroot", o("arma"), "--psd_estimator", "ARMA"] + dev)
        _run(prog("ctf_estimate_from_micrograph"),
             mic + ["--oroot", o("acc"), "--pieceDim", str(PIECE),
                    "--mode", "regions", "--skipBorders", "0",
                    "--acceleration1D"] + FIT + dev)
        _run(prog("ctf_estimate_from_psd"),
             psd + ["-o", o("fd.ctfparam"), "--fastDefocus", "2", "10",
                    "--radial_noise", "--show_optimization"] + FIT + dev)
        _run(prog("ctf_estimate_from_psd"),
             psd + ["-o", o("sim.ctfparam"), "-s", str(TS),
                    "--ctf_similar_to", str(d / "seed.ctfparam"),
                    "--noDefocus"] + dev)
        out[side] = o
    return out


def test_program_flags_match_the_reference(flag_runs):
    """--Nsubpiece and --psd_estimator ARMA (PSDs to 1e-5),
    --acceleration1D per region, --fastDefocus with --radial_noise and
    --show_optimization (also within 5 % of the plant), --ctf_similar_to
    with --noDefocus (the seed's defocus kept exactly);
    --downSamplingPerformed runs in test_psd_programs_match_the_reference."""
    ref, port = flag_runs["ref"], flag_runs["port"]
    for name in ("sub.psd", "arma.psd"):
        assert rel_err(_img(port(name)), _img(ref(name))) <= 1e-5, name
    assert _img(port("sub.psd")).shape == (64, 64)
    g, w = _rows(port("acc_regions.xmd")), _rows(ref("acc_regions.xmd"))
    assert len(g) == len(w) == 9
    for a, b in zip(g, w):
        _ctf_close(a, b)
        assert a["ctfDefocusU"] == a["ctfDefocusV"]
    for name in ("fd.ctfparam", "sim.ctfparam"):
        got, want = _rows(port(name))[0], _rows(ref(name))[0]
        _ctf_close(got, want)
    got = _rows(port("fd.ctfparam"))[0]
    assert got["ctfBgSqrtU"] == got["ctfBgSqrtV"]
    for lbl, true in (("ctfDefocusU", TRUTH["defocusU"]),
                      ("ctfDefocusV", TRUTH["defocusV"])):
        assert abs(float(got[lbl]) - true) <= 0.05 * true
    got = _rows(port("sim.ctfparam"))[0]
    assert (got["ctfDefocusU"], got["ctfDefocusV"]) == (11500.0, 10000.0)


UNREAD = ["--energy_loss", "3", "--lens_stability", "2", "--convergence_cone",
          "0.5", "--longitudinal_displace", "100", "--transversal_displace",
          "5", "--K", "7", "--phase_shift", "0.3"]


def test_reference_ignores_the_flags_the_fit_does_not_read(work, runs):
    """The reference's fault that the port does not copy (ROADMAP §3 item
    6): its ctf_estimate_from_psd accepts the seven flags and writes the
    same model as without them (the two runs back to back)."""
    got = []
    for extra in ([], UNREAD):
        out = str(work / f"ref_unread{len(got)}.ctfparam")
        _run(jax_program("ctf_estimate_from_psd"),
             ["--psd", str(work / "ref_mic.psd"), "-o", out] + FIT + extra)
        got.append(_rows(out))
    assert got[0] == got[1]


@pytest.mark.parametrize("flag", [["--K", "1"], ["--energy_loss", "0.5"],
                                  ["--fastDefocus", "3", "10"]])
def test_flags_the_fit_does_not_read_raise(work, flag):
    with pytest.raises(XmippError, match="ROADMAP"):
        get_program("ctf_estimate_from_psd").read(
            ["x", "--psd", str(work / "ref_mic.psd"), "--device", "cpu"]
            + flag)


def test_regions_mesh_dp_over_two_ranks(work, runs, tmp_path):
    """--mode regions --mesh dp over two gloo ranks: rank 0 writes the rows
    of the serial port (1e-4) and of the reference's --mesh dp on its
    virtual 8-device mesh (1 %); rank 1 writes nothing."""
    out = tmp_path / "mesh"
    argv = ["--micrograph", str(work / "mic.mrc"), "--pieceDim", str(PIECE),
            "--oroot", str(out), "--mode", "regions", "--skipBorders", "0",
            "--mesh", "dp"] + FIT
    ranks = Ranks(2, [dict(name="regions", program=
                           "ctf_estimate_from_micrograph", argv=argv)],
                  tmp_path, {})
    _run(jax_program("ctf_estimate_from_micrograph"),
         argv[:5] + [str(tmp_path / "ref_mesh")] + argv[6:])
    reports = ranks.join()
    for r in reports:
        assert r["jobs"]["regions"]["rc"] == 0, r
        assert r["modules"] == []
    assert reports[1]["jobs"]["regions"]["writes"] == 0
    got = _rows(str(out) + "_regions.xmd")
    serial = _rows(runs["port"]("reg_regions.xmd"))
    ref = _rows(str(tmp_path / "ref_mesh") + "_regions.xmd")
    for a, b, c in zip(got, serial, ref):
        _ctf_close(a, b, 1e-4)
        _ctf_close(a, c)
