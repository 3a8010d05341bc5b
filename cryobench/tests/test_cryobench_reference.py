"""The plain reference against the program's CPU path at N=32, the work
counts of the rooflines on hand-checked shapes, the controls, and the
faults that the check must catch."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cryobench import control, roofline, run
from cryobench import data as data_mod
from cryobench.reference import dft, match as mref, reconstruct as rref
from cryobench.symmetry import group

SEED = 2 ** 33 + 17
CPU = torch.device("cpu")


def tiny_cfg(sym="c1"):
    from cryobench.tests.conftest import TINY
    return {"sizes": dict(TINY, sym=sym), "particles": 128,
            "map": {"extent_A": 70, "blobs_per_asymmetric_unit": 6,
                    "blob_sigma_px": [1.5, 3.0]},
            "ctf": {"group": 32, "defocus_A": [8000, 30000],
                    "astigmatism_A": 300, "cs_mm": 2.7, "q0": 0.1},
            "shift_px": 3.0, "noise_sigma": 0.5}


def test_cross_work_on_a_hand_checked_shape():
    # operands 8 (2 + 4) 3 5 + weights 4 3 + two spectra 2 8 2 4 5;
    # 8 flops for each of 2 x 3 x 4 x 5 (image, ring, reference, harmonic)
    assert roofline.cross_work(2, 3, 4, 5) == (720 + 12 + 640, 960)
    assert roofline.cross_work(2, 3, 4, 5, mirror=False) == (1052, 960)
    assert roofline.scan_rings(360) == 89 and roofline.scan_rings(256) == 63


def test_kb_taps_on_hand_checked_samples():
    """A sample at (10.5, 10.5, 10.5): per axis the taps 9..12 lie at 1.5,
    0.5, 0.5, 1.5; within 1.9 are the 8 taps with all three at 0.5 and
    the 24 with one at 1.5. A second sample at the same place touches the
    same voxels; one whose floor lies outside the cube is dropped."""
    one = [torch.tensor([10.5])] * 3
    assert roofline.kb_tap_stats([one], 32, 1.9) == (1, 32, 32)
    two = [torch.tensor([10.5, 10.5])] * 3
    out = [torch.tensor([32.2]), torch.tensor([10.5]), torch.tensor([10.5])]
    assert roofline.kb_tap_stats([two, out], 32, 1.9) == (3, 64, 32)
    assert roofline.kb_work(1, 32, 32) == (24 + 32 * 24, 32 * 28 + 6)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11])
    assert dft.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9]


def test_dft_products_match_the_fft():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 12, 10), generator=g)
    re, im = dft.rfft2(x, "fp32")
    want = torch.fft.rfft2(x)
    assert torch.allclose(re, want.real, atol=1e-4)
    assert torch.allclose(im, want.imag, atol=1e-4)
    assert torch.allclose(dft.irfft2(re, im, (12, 10), "fp32"), x,
                          atol=1e-5)


def test_gallery_matches_the_programs_projector():
    from xmipp3_tpu_torch.ops.project import FourierProjector
    from xmipp3_tpu_torch.core.sampling import Sampling
    cfg = tiny_cfg()
    blobs = data_mod.blob_map(cfg, np.random.default_rng(3))
    vol = data_mod.volume(blobs, 32, CPU)
    angles = np.asarray(Sampling(15, "c1").angles, np.float32)[:40]
    want = FourierProjector(vol, 2.0, device="cpu").project_euler(
        angles[:, 0], angles[:, 1], np.zeros(len(angles), np.float32))
    got = mref.gallery(mref.pad_spectrum(vol), angles, 32, "fp32")
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_exact_projections_match_the_programs_projector():
    """The data's exact line integrals and the program's Fourier projection
    of the sampled map agree (the same pose and shift conventions)."""
    from xmipp3_tpu_torch.ops.project import FourierProjector
    cfg = tiny_cfg()
    blobs = data_mod.blob_map(cfg, np.random.default_rng(4))
    vol = data_mod.volume(blobs, 32, CPU)
    p = data_mod.poses(np.random.default_rng(5), 8, 0.0)
    exact = data_mod.projections(blobs, 32, p, 0, 8, CPU)
    proj = FourierProjector(vol, 2.0, device="cpu").project_euler(
        p["rot"], p["tilt"], p["psi"])
    corr = mref.ncc(exact, proj)
    assert float(corr.min()) > 0.99


def test_match_reference_follows_the_program():
    from xmipp3_tpu_torch.ops.match import match_to_gallery
    cfg = tiny_cfg()
    d = data_mod.make(cfg, SEED, CPU)
    from xmipp3_tpu_torch.core.sampling import Sampling
    angles = np.asarray(Sampling(15, "c1").angles, np.float32)
    G = mref.gallery(mref.pad_spectrum(d.vol), angles, 32, "fp32")
    imgs = d.stack[:48]
    prog = match_to_gallery(G, imgs, max_shift=4, radius_min=2,
                            radius_max=14, device="cpu")
    mine = mref.match(G, imgs, 4, "fp32")
    same = ((prog["ref_idx"] == mine["ref_idx"])
            & (prog["flip"] == mine["flip"]))
    assert float(same.float().mean()) > 0.95
    assert float((prog["peak"] - mine["peak"]).abs().max()) < 1e-5
    dpsi = torch.remainder(prog["psi"] - mine["psi"] + 180, 360) - 180
    assert float(dpsi[same].abs().max()) < 0.02
    assert float((prog["corr"] - mine["corr"])[same].abs().max()) < 1e-4


@pytest.mark.parametrize("sym", ["c1", "d2"])
def test_reconstruct_reference_follows_the_program(sym):
    from cryobench.jobs.reconstruct import Job
    cfg = tiny_cfg(sym)
    cfg["precision"] = {"reconstruct": "float32"}
    mix = {"batch": 64, "pad": 2, "interp": "kb", "blob": [1.9, 0, 15],
           "max_freq": 0.5, "min_ctf": 0.1, "phase_flipped": True}
    d = data_mod.make(cfg, SEED, CPU)
    job = Job(cfg, mix, d, CPU, run.Spans(False, CPU), SEED)
    rec = job.reconstructor()
    for s in range(0, 128, 64):
        job.add(rec, s, s + 64)
    vol = rec.finish()
    vox = rref.sample_voxels(np.random.default_rng(1), 300, rec.P)
    lo, hi = rref.voxel_sums(vox, d.stack, d.poses, d.groups, d.group_of,
                             group(sym), cfg, mix, "fp32")
    lin = torch.as_tensor((vox[:, 0] * rec.P + vox[:, 1]) * rec.P + vox[:, 2])
    got = torch.stack([c.reshape(-1)[lin].double()
                       for c in (rec.data_r, rec.data_i, rec.weights)])
    dist = torch.clamp(torch.maximum(lo - got, got - hi), min=0)
    assert float((dist.amax(1) / hi.abs().amax(1)).max()) < 1e-3
    want = rref.finalize(rec.data_r, rec.data_i, rec.weights, 32, "fp32")
    assert float((vol.double() - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("cell", ["tiny_c1.match", "tiny_d2.reconstruct"])
def test_control_fails_where_the_program_passes(tiny_root, cell):
    """The control (the reference one precision below the configuration's,
    in the program's place) reads at least ten times the program's reading
    on every number it can move, and fails the cell's limits."""
    from cryobench.tests.conftest import TINY_LIMITS
    kind = cell.split(".")[1]
    rows = control.readings(cell, [SEED], 1, tiny_root, device="cpu",
                            emit=lambda _: None)
    prog, ctrl = rows[0]["program"], rows[0]["control"]
    for name, limit in TINY_LIMITS[kind].items():
        assert prog[name] <= limit, (name, prog[name])
        if name != "dirs_unmatched":
            assert ctrl[name] >= 10 * max(prog[name], 1e-12), name
    assert any(ctrl[n] > lim for n, lim in TINY_LIMITS[kind].items())


def _fault(monkeypatch, kind: str, fault: str):
    """Break the timed path underneath the harness."""
    import xmipp3_tpu_torch.ops.match as om
    import xmipp3_tpu_torch.ops.reconstruct as orc
    if kind == "match":
        real = om.match_to_gallery

        def broken(refs, imgs, **kw):
            if fault == "state":          # the refinement left undone
                kw["refine_iters"] = 0
                monkeypatch.setattr(om, "best_shift_from_spectra",
                                    lambda *a, **k: (torch.zeros(len(imgs)),
                                                     torch.zeros(len(imgs)),
                                                     None))
            res = real(refs, imgs, **kw)
            if fault == "half":           # half left out, the rest's mean
                h = len(imgs) // 2
                for k, v in res.items():
                    if k != "aligned":
                        res[k] = v.clone()
                        res[k][h:] = v[:h].float().mean().to(v.dtype)
            if fault == "answer":         # psi altered where produced
                res["psi"] = res["psi"] + 0.5
            return res
        monkeypatch.setattr(om, "match_to_gallery", broken)
        return
    real_bp = orc.backproject_chunk
    real_fin = orc.finalize_volume

    def bp(data_r, data_i, weights, imgs, mats, sx, sy, img_w, *a, **kw):
        if fault == "state":              # the cubes left unchanged
            return data_r, data_i, weights
        if fault == "half":               # half left out, the rest doubled
            h = len(imgs) // 2
            img_w = np.concatenate([2 * np.asarray(img_w[:h]),
                                    np.zeros(len(imgs) - h, np.float32)])
        return real_bp(data_r, data_i, weights, imgs, mats, sx, sy, img_w,
                       *a, **kw)

    def fin(*a, **kw):
        vol = real_fin(*a, **kw)
        return vol * (1 + 1e-3) if fault == "answer" else vol
    monkeypatch.setattr(orc, "backproject_chunk", bp)
    monkeypatch.setattr(orc, "finalize_volume", fin)


@pytest.mark.parametrize("fault", ["state", "half", "answer"])
@pytest.mark.parametrize("cell", ["tiny_c1.match", "tiny_d2.reconstruct"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    _fault(monkeypatch, cell.split(".")[1], fault)
    res = run.run(cell, SEED, 1.5, False, tiny_root, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny_c1.match", "tiny_d2.match"])
def test_wrong_gallery_directions_are_not_correct(tiny_root, monkeypatch,
                                                  cell):
    """The gallery's directions turned by a degree about z, their count
    unchanged: the reference's own sampling catches it."""
    import xmipp3_tpu_torch.core.sampling as sm
    real = sm.Sampling

    class Turned(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.angles = self.angles + np.array([1.0, 0.0])
    monkeypatch.setattr(sm, "Sampling", Turned)
    res = run.run(cell, SEED, 1.0, False, tiny_root, device="cpu")
    assert res["checks"]["dirs_unmatched"]["value"] > 0
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("rate", [5, 7.5, 15])
@pytest.mark.parametrize("sym", ["c1", "c3", "c4", "d2", "d5", "t", "o",
                                 "i1", "i2", "i3", "i4"])
def test_reference_sampling_is_the_programs(rate, sym):
    """The reference's gallery directions, derived from the rate and the
    symmetry alone, are the program's set, and its groups the program's."""
    from cryobench.reference import sampling
    from xmipp3_tpu_torch.core.sampling import Sampling
    from xmipp3_tpu_torch.core.sym import symmetry_matrices
    mine = sampling.directions(rate, sym)
    prog = np.asarray(Sampling(rate, sym).angles, np.float32)
    order, unmatched = sampling.pair(prog, mine, 1e-3)
    assert unmatched == 0 and len(prog) == len(mine)
    key = lambda g: {tuple(np.round(m, 5).ravel() + 0.0) for m in g}
    assert key(group(sym)) == key(symmetry_matrices(sym))
    assert len(group(sym)) == len(symmetry_matrices(sym))


def test_control_precision_follows_the_configuration():
    assert control.control_precision(
        {"precision": {"match": "float32, TF32 off"}}, "match") == "tf32"
    assert control.control_precision(
        {"precision": {"reconstruct": "float32"}}, "reconstruct") == "bf16"


@pytest.mark.cuda
def test_a_tiny_cell_runs_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("tiny_c1.match", "tiny_d2.reconstruct"):
        res = run.run(cell, SEED, 1.0, False, tiny_root, device="cuda")
        assert res["correct"], res["checks"]
