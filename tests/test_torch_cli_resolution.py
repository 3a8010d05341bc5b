"""The port's resolution programs (resolution_monogenic_signal,
resolution_monotomo, resolution_fso, resolution_localfilter,
volume_correct_bfactor, volume_structure_factor, resolution_directional)
against the reference's programs on the same files, the port with
--device cpu.

The maps are two half maps of a 36^3 blob phantom at 1.5 A/px, low-passed
to 0.3 and given independent noise. Held to: resolution maps equal on
>= 99.9 % of the masked voxels and never more than one band apart;
median resolutions within one band; FSO curves equal and the 3DFSC 1e-6,
its filtered map 1e-5 of the max; filtered and sharpened maps 1e-4 of the
max and B-factors 1e-3 relative; structure factors 1e-5 absolute in log;
resolution_directional's maps equal on >= 99.9 % of the masked voxels
(its z-score map within 1e-3 there) and its metadata 1e-4 relative.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from test_torch_monogenic import blob_volume, sphere
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)
SIDES = (("ref", jax_program, []), ("port", get_program, ["--device", "cpu"]))
N, TS = 36, 1.5


def both(name, args_of):
    out = {}
    for side, prog, extra in SIDES:
        p = prog(name)
        assert p.run_with_args(args_of(side).split() + ["-v", "0", *extra]) \
            == 0, (side, name)
        out[side] = p
    return out


def load(fn):
    return np.squeeze(Image(str(fn)).data)


def md_rows(fn):
    md = MetaData(str(fn))
    return [md.getRow(i) for i in md]


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    rng = np.random.default_rng(11)
    half = [blob_volume(N, 3, sigma_noise=0.0, blur=0.3)
            + 0.25 * rng.standard_normal((N, N, N)).astype(np.float32)
            for _ in range(2)]
    for k, v in enumerate(half):
        save_image(str(d / f"h{k + 1}.vol"), v.astype(np.float32))
    save_image(str(d / "mask.vol"), sphere(N, N // 3).astype(np.float32))
    excl = sphere(N, N // 2 - 1) & ~sphere(N, N // 2 - 3)
    save_image(str(d / "excl.vol"), excl.astype(np.float32))
    save_image(str(d / "res.vol"), rng.uniform(3.5, 12.0, (N, N, N))
               .astype(np.float32))
    MetaData.fromRows({"resolutionFreq": (i + 0.5) / N / TS,
                       "resolutionFRC": float(np.exp(-i / 6.0))}
                      for i in range(N // 2)).write(str(d / "fsc.xmd"))
    return d


def hold_resolution(got, want, mask, tol_share=0.999):
    eq = np.isclose(got[mask], want[mask], rtol=1e-5)
    assert eq.mean() >= tol_share, eq.mean()
    levels = np.unique(np.concatenate([got[mask], want[mask]]))
    idx = lambda a: np.searchsorted(levels, a)
    assert np.abs(idx(got[mask]) - idx(want[mask])).max() <= 1


MONORES = {
    "halves": "--vol2 {d}/h2.vol --mask {d}/mask.vol",
    "single_default_mask": "--steps 12",
    "excl_gauss": "--vol2 {d}/h2.vol --mask {d}/mask.vol --maskExcl "
                  "{d}/excl.vol --gaussian --steps 10",
    "in_halves_step": "--vol2 {d}/h2.vol --mask {d}/mask.vol "
                      "--noiseonlyinhalves --step 1 --minRes 15 --maxRes 3.5",
    "significance": "--vol2 {d}/h2.vol --mask {d}/mask.vol "
                    "--significance 0.99 --steps 8",
}


@pytest.mark.parametrize("case", sorted(MONORES))
def test_monores_matches(maps, case):
    d = maps
    progs = both("resolution_monogenic_signal", lambda s:
                 f"--vol {d}/h1.vol -o {d}/mr_{case}_{s}.vol "
                 f"--sampling_rate {TS} " + MONORES[case].format(d=d))
    got, want = (load(d / f"mr_{case}_{s}.vol") for s in ("port", "ref"))
    mask = want > 0
    assert (got > 0).sum() == mask.sum() and len(np.unique(want[mask])) > 3
    hold_resolution(got, want, mask)
    assert abs(progs["port"].median_resolution
               - progs["ref"].median_resolution) <= 0.5


@pytest.mark.parametrize("flags", ["--mask {d}/mask.vol --step 1 --minRes 15 "
                                   "--maxRes 3.5",
                                   "--meanVol {d}/h1.vol --step 2"])
def test_monotomo_matches(maps, flags):
    d = maps
    tag = "mask" if "mask" in flags else "mean"
    both("resolution_monotomo", lambda s:
         f"--vol {d}/h1.vol --vol2 {d}/h2.vol -o {d}/mt_{tag}_{s}.vol "
         f"--sampling_rate {TS} " + flags.format(d=d))
    got, want = (load(d / f"mt_{tag}_{s}.vol") for s in ("port", "ref"))
    mask = want > 0
    hold_resolution(got, want, mask)


@pytest.mark.parametrize("flags", ["", "--mask {d}/mask.vol --anglecone 30 "
                                   "--threshold 0.5 --threedfsc_filter"])
def test_fso_matches(maps, tmp_path, flags):
    d = maps
    for s in ("ref", "port"):
        (tmp_path / s).mkdir()
    both("resolution_fso", lambda s:
         f"--half1 {d}/h1.vol --half2 {d}/h2.vol -o {tmp_path}/{s}/fso.xmd "
         f"--sampling {TS} " + flags.format(d=d))
    rows = [md_rows(tmp_path / s / "fso.xmd") for s in ("port", "ref")]
    assert len(rows[0]) == len(rows[1]) == N // 2
    for g, w in zip(*rows):
        assert g["resolutionFRC"] == w["resolutionFRC"]
        assert g["resolutionFreq"] == pytest.approx(w["resolutionFreq"],
                                                    rel=1e-12)
    if flags:
        got, want = (load(tmp_path / s / "3dFSC.mrc") for s in
                     ("port", "ref"))
        assert np.abs(got - want).max() <= 1e-6
        assert rel_err(load(tmp_path / "port" / "filteredMap.mrc"),
                       load(tmp_path / "ref" / "filteredMap.mrc")) <= 1e-5


@pytest.mark.parametrize("flags", ["--sampling 1.5", "--sampling_rate 1.5 "
                                   "--step 0 --filteredMap {d}/lf2_{s}.vol"])
def test_localfilter_matches(maps, flags):
    d = maps
    both("resolution_localfilter", lambda s:
         f"--vol {d}/h1.vol --resvol {d}/res.vol -o {d}/lf_{s}.vol "
         + flags.format(d=d, s=s))
    assert rel_err(load(d / "lf_port.vol"), load(d / "lf_ref.vol")) <= 1e-4
    if "filteredMap" in flags:
        assert rel_err(load(d / "lf2_port.vol"), load(d / "lf_ref.vol")) \
            <= 1e-4


@pytest.mark.parametrize("flags", ["--auto --fit_minres 12",
                                   "--adhoc -40 --maxres 4",
                                   "--auto --fit_maxres 4 --fsc {d}/fsc.xmd"])
def test_correct_bfactor_matches(maps, flags):
    d = maps
    progs = both("volume_correct_bfactor", lambda s:
                 f"-i {d}/h1.vol -o {d}/bf_{s}.vol --sampling {TS} "
                 + flags.format(d=d))
    assert progs["port"].B == pytest.approx(progs["ref"].B, rel=1e-3,
                                            abs=1e-6)
    assert rel_err(load(d / "bf_port.vol"), load(d / "bf_ref.vol")) <= 1e-4


def test_structure_factor_matches(maps):
    d = maps
    both("volume_structure_factor",
         lambda s: f"-i {d}/h1.vol -o {d}/sf_{s}.xmd --sampling {TS}")
    rows = [md_rows(d / f"sf_{s}.xmd") for s in ("port", "ref")]
    assert len(rows[0]) == len(rows[1]) == N // 2
    for g, w in zip(*rows):
        assert g["logStructureFactor"] == pytest.approx(
            w["logStructureFactor"], abs=1e-5)
        assert g["resolutionFreq"] == w["resolutionFreq"]


DIR_OUTPUTS = ("radial", "azimuthal", "highest", "lowest", "doa1", "doa2",
               "monores")


def test_resolution_directional_matches(maps):
    d = maps
    md_flags = ("--radialAzimuthalThresholds {r}_thr.xmd --radialAvG "
                "{r}_avg.xmd --prefMin {r}_pref.xmd --zScoremap {r}_z.vol")
    progs = both("resolution_directional", lambda s:
                 f"--vol {d}/h1.vol --mask {d}/mask.vol --oroot {d}/md_{s} "
                 f"--sampling_rate {TS} --ndirections 9 --steps 6 "
                 f"--resStep 1 --volumeRadius 14 "
                 + md_flags.format(r=f"{d}/md_{s}"))
    mask = load(d / "mask.vol") > 0.5
    for out in DIR_OUTPUTS:
        got, want = (load(d / f"md_{s}_{out}.vol") for s in ("port", "ref"))
        eq = np.isclose(got[mask], want[mask], rtol=1e-5, atol=1e-6)
        assert eq.mean() >= 0.999, (out, eq.mean())
        assert np.array_equal(got[~mask], want[~mask]), out
    z = [load(d / f"md_{s}_z.vol") for s in ("port", "ref")]
    assert np.abs(z[0] - z[1])[mask].max() <= 1e-3
    for stem in ("thr", "avg", "pref"):
        rows = [md_rows(d / f"md_{s}_{stem}.xmd") for s in ("port", "ref")]
        assert len(rows[0]) == len(rows[1])
        for g, w in zip(*rows):
            for k, v in w.items():
                assert g[k] == pytest.approx(v, rel=1e-4, abs=1e-6), (stem, k)
    assert progs["port"].mean_resolution == pytest.approx(
        progs["ref"].mean_resolution, rel=1e-5)


@pytest.mark.parametrize("name,args", [
    ("resolution_monogenic_signal", "--vol {m}/h1.vol -o {d}/r.vol"),
    ("resolution_monotomo", "--vol {m}/h1.vol --vol2 {m}/h2.vol -o {d}/r.vol"),
    ("resolution_fso", "--half1 {m}/h1.vol --half2 {m}/h2.vol -o {d}/f.xmd"),
    ("resolution_localfilter", "--vol {m}/h1.vol --resvol {m}/res.vol -o "
                               "{d}/l.vol"),
    ("volume_correct_bfactor", "-i {m}/h1.vol -o {d}/b.vol"),
    ("volume_structure_factor", "-i {m}/h1.vol -o {d}/s.xmd"),
    ("resolution_directional", "--vol {m}/h1.vol --oroot {d}/md")])
def test_resolution_programs_without_a_card_raise(monkeypatch, maps,
                                                  tmp_path, name, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        get_program(name).run_with_args(
            args.format(d=tmp_path, m=maps).split())
    assert not list(tmp_path.iterdir())
