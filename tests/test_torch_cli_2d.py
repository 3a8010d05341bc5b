"""The slice as a whole: the port's transform_filter, transform_normalize,
transform_geometry and image_align programs against the reference's on the
same files, the port with --device cpu (N=48, B<=12).

Held to: filtered, normalized and warped stacks <= 1e-5 * max (the
B-spline warps of transform_geometry too); metadata columns equal, or for
poses within 1e-4; image_align's rows to the tolerances of
tests/test_torch_align.py (psi 0.1 degree, shifts 0.02 px, maxCC 1e-4,
flips equal; on a mirrored row the reference writes psi + 180 and the
negated shifts, a fault of the reference that the port does not copy,
ROADMAP §3 item 4) and its --oaligned stack 1e-3 * max (a psi within the 0.1
degree tolerance moves an edge pixel of the warp by up to 0.04 px; the
views that cannot align without their mirror agree least). The views are
tests/test_torch_align.py's (psi away from the 45 + k*90 ties).
"""
import os

import numpy as np
import pytest
import torch

from test_torch_align import _ref, _views
from test_torch_common import rel_err
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops.ctf import CTFDescription
from xmipp3_tpu_torch.programs import get_program, list_programs

torch.set_num_threads(1)
B = 12
SIDES = (("ref", jax_program, []), ("port", get_program, ["--device", "cpu"]))


def _rows(fn):
    md = MetaData(str(fn))
    return [md.getRow(i) for i in md]


def _stack(fn):
    return np.squeeze(Image(str(fn)).data)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Views of an asymmetric blob image (a stack; the same views on a
    positive background, as a stack and as a metadata with poses and tilt
    angles), its clean image, a CTF file, a basis stack and a volume."""
    d = tmp_path_factory.mktemp("cli2d")
    imgs = _views(B, 21)
    save_image(str(d / "views.mrcs"), imgs)
    save_image(str(d / "pos.mrcs"), imgs + 2.0)
    rng = np.random.default_rng(22)
    MetaData.fromRows(
        {"image": f"{i + 1:06d}@{d}/pos.mrcs", "itemId": i + 1,
         "angleRot": float(rng.uniform(0, 360)),
         "angleTilt": float(rng.uniform(-60, 60)),
         "anglePsi": float(rng.uniform(-180, 180)),
         "shiftX": float(rng.uniform(-3, 3)),
         "shiftY": float(rng.uniform(-3, 3)), "flip": int(i % 3 == 0)}
        for i in range(B)).write(str(d / "pos.xmd"))
    save_image(str(d / "clean.xmp"), _ref())
    CTFDescription(sampling_rate=2.0, voltage=300, Cs=2.7, Q0=0.1,
                   defocusU=12000, defocusV=12600,
                   azimuthal_angle=20.0).write(str(d / "m.ctfparam"))
    save_image(str(d / "basis.stk"), rng.standard_normal(
        (3, 48, 48)).astype(np.float32) / 48)
    save_image(str(d / "vol.vol"), rng.standard_normal(
        (16, 16, 16)).astype(np.float32))
    return d


def _both(work, program, args, out):
    """Run the program on both sides; args name '{o}' where the side's
    output goes. Returns the two output paths (ref, port)."""
    paths = []
    for side, prog, dev in SIDES:
        o = str(work / f"{side}_{out}")
        argv = [a.format(d=work, o=o) for a in args] + dev + ["-v", "0"]
        assert prog(program).run_with_args(argv) == 0, (side, argv)
        paths.append(o)
    return paths


FILTERS = [
    ["--fourier", "low_pass", "0.25"], ["--fourier", "band_pass", "0.05",
                                        "0.3", "0.02"],
    ["--fourier", "low_pass", "10", "--sampling", "2"],
    ["--fourier", "ctf", "{d}/m.ctfparam"], ["--fourier", "gaussian", "0.1"],
    ["--fourier", "sparsify", "0.5"],
    ["--wavelet", "DAUB4", "remove_scale", "--scale", "1"],
    ["--wavelet", "DAUB12", "bayesian", "0.1", "0.3"],
    ["--wavelet", "HAAR", "soft_thresholding"],
    ["--wavelet", "DAUB4", "soft_thresholding", "--waveletThreshold", "2"],
    ["--bad_pixels", "outliers", "2.5"], ["--bad_pixels", "negative"],
    ["--mean_shift", "1", "3", "1"], ["--background", "plane"],
    ["--background", "rollingball", "5"], ["--median"],
    ["--diffusion", "--shah_iter", "2", "1", "1"],
    ["--basis", "{d}/basis.stk", "2"], ["--log"], ["--retinex", "0.9"],
    ["--tv", "0.1", "10"], ["--denoiseTV", "--maxIterTV", "5"]]


@pytest.mark.parametrize("flags", FILTERS, ids=lambda f: "_".join(f[:2]))
def test_transform_filter(work, flags):
    ref, port = _both(work, "transform_filter",
                      ["-i", "{d}/pos.mrcs", "-o", "{o}"] + flags,
                      "filt.mrcs")
    want = _stack(ref)
    if flags[:2] == ["--fourier", "sparsify"]:
        # the threshold can tie a conjugate pair (test_torch_fourier_filter)
        got = _stack(port)
        same = np.abs(got - want).reshape(B, -1).max(1) <= \
            1e-5 * np.abs(want).max()
        assert same.sum() >= B // 2
        return
    assert rel_err(_stack(port), want) <= 1e-5


NORMALIZE = [["--method", m, "--background", "circle", "18"] for m in
             ("NewXmipp", "OldXmipp", "Near_OldXmipp", "NewXmipp2", "Ramp",
              "Michael", "Robust", "Neighbour", "None")] + [
    ["--method", "NewXmipp"], ["--method", "Robust", "--clip",
                               "--background", "circle", "18"],
    ["--method", "Random", "--prm", "0.5", "1.5", "-1", "1"],
    ["--method", "NewXmipp", "--invert", "--thr_black_dust", "-2",
     "--thr_white_dust", "2", "--background", "circle", "18"],
    ["--method", "Tomography"], ["--method", "Tomography0", "--tiltMask"]]


@pytest.mark.parametrize("flags", NORMALIZE, ids=lambda f: "_".join(f[:4]))
def test_transform_normalize(work, flags):
    ref, port = _both(work, "transform_normalize",
                      ["-i", "{d}/pos.xmd", "-o", "{o}"] + flags,
                      "norm.mrcs")
    assert rel_err(_stack(port), _stack(ref)) <= 1e-5


GEOMETRY = [["--rotate", "30"], ["--rotate", "-75", "--interp", "linear"],
            ["--shift", "2.5", "-1.5", "0", "--dont_wrap"],
            ["--scale", "1.1", "--flip", "--inverse"],
            ["--matrix", "0.8 -0.6 1.5 0.6 0.8 -2 0 0 1"],
            ["--rotate", "20", "--write_matrix"]]


@pytest.mark.parametrize("flags", GEOMETRY, ids=lambda f: "_".join(f[:2]))
def test_transform_geometry_stack(work, flags):
    ref, port = _both(work, "transform_geometry",
                      ["-i", "{d}/views.mrcs", "-o", "{o}"] + flags,
                      "geo.mrcs")
    assert rel_err(_stack(port), _stack(ref)) <= 1e-5


@pytest.mark.parametrize("flags", [["--apply_transform"],
                                   ["--apply_transform", "--rotate", "15",
                                    "--interp", "linear"],
                                   ["--apply_transform", "--dont_wrap"],
                                   ["--shift_to", "3", "-2", "1",
                                    "--apply_transform"]])
def test_transform_geometry_metadata_applied(work, flags):
    ref, port = _both(work, "transform_geometry",
                      ["-i", "{d}/pos.xmd", "-o", "{o}"] + flags,
                      "geo.mrcs")
    assert rel_err(_stack(port), _stack(ref)) <= 1e-5


@pytest.mark.parametrize("flags", [["--rotate", "30"],
                                   ["--shift", "1", "2", "0", "--flip"],
                                   ["--shift_to", "3", "-2", "1"],
                                   ["--scale", "0.9"]])
def test_transform_geometry_rewrites_labels(work, flags):
    ref, port = _both(work, "transform_geometry",
                      ["-i", "{d}/pos.xmd", "-o", "{o}"] + flags,
                      "geo.xmd")
    rr, pr = _rows(ref), _rows(port)
    assert len(rr) == len(pr) == B
    for a, b in zip(rr, pr):
        assert sorted(a) == sorted(b)
        for k, v in a.items():
            if isinstance(v, float):
                assert abs(v - b[k]) <= 1e-4, k
            else:
                assert v == b[k], k


@pytest.mark.parametrize("flags", [["--rotate_volume", "euler", "30", "40",
                                    "50"],
                                   ["--rotate_volume", "axis", "25", "0", "1",
                                    "1", "--dont_wrap"],
                                   ["--rotate_volume", "alignZ", "1", "1",
                                    "0", "--inverse"]])
def test_transform_geometry_volume(work, flags):
    ref, port = _both(work, "transform_geometry",
                      ["-i", "{d}/vol.vol", "-o", "{o}"] + flags, "rot.vol")
    assert rel_err(_stack(port), _stack(ref)) <= 1e-5


def _align_rows_agree(ref, port):
    rr, pr = _rows(ref), _rows(port)
    assert len(rr) == len(pr) == B
    col = lambda rows, k: np.array([float(r[k]) for r in rows])
    flip = col(pr, "flip")
    np.testing.assert_array_equal(flip, col(rr, "flip"))
    # the reference's mirrored rows: psi + 180 and the shifts negated
    sign = np.where(flip > 0, -1.0, 1.0)
    dpsi = (col(pr, "anglePsi") + 180 * (flip > 0) - col(rr, "anglePsi")
            + 180) % 360 - 180
    assert np.abs(dpsi).max() <= 0.1
    for k in ("shiftX", "shiftY"):
        assert np.abs(sign * col(pr, k) - col(rr, k)).max() <= 0.02, k
    assert np.abs(col(pr, "maxCC") - col(rr, "maxCC")).max() <= 1e-4
    return flip


@pytest.mark.parametrize("flags", [["--ref", "{d}/clean.xmp"],
                                   ["--ref", "{d}/clean.xmp", "--dont_mirror"],
                                   ["--iter", "2"], ["--pspc", "--iter", "1"]],
                         ids=["ref", "ref_nomirror", "free", "pspc"])
def test_image_align(work, flags):
    paths = _both(work, "image_align",
                  ["-i", "{d}/views.mrcs", "-o", "{o}.xmd", "--max_shift",
                   "6", "--oaligned", "{o}.mrcs"] + flags, "al")
    ref, port = paths
    flip = _align_rows_agree(ref + ".xmd", port + ".xmd")
    if "--dont_mirror" not in flags and "--ref" in flags:
        assert 0 < flip.sum() < B
    want = _stack(ref + ".mrcs")
    assert rel_err(_stack(port + ".mrcs"), want) <= 1e-3
    if "--ref" not in flags:
        assert rel_err(_stack(port + "_avg.mrcs"),
                       _stack(ref + "_avg.mrcs")) <= 1e-3


def test_image_align_pose_convention_end_to_end(work, tmp_path):
    """transform_geometry --apply_transform of image_align's rows reproduces
    image_align's --oaligned stack image by image, mirrored rows included
    (the pose convention, end to end)."""
    al = str(tmp_path / "al")
    assert get_program("image_align").run_with_args(
        ["-i", f"{work}/views.mrcs", "-o", al + ".xmd", "--ref",
         f"{work}/clean.xmp", "--max_shift", "6", "--oaligned",
         al + ".mrcs", "--device", "cpu", "-v", "0"]) == 0
    assert 0 < sum(r["flip"] for r in _rows(al + ".xmd")) < B
    geo = str(tmp_path / "geo.mrcs")
    assert get_program("transform_geometry").run_with_args(
        ["-i", al + ".xmd", "-o", geo, "--apply_transform", "--device",
         "cpu", "-v", "0"]) == 0
    a, g = _stack(al + ".mrcs"), _stack(geo)
    for i in range(B):
        assert np.corrcoef(a[i].ravel(), g[i].ravel())[0, 1] >= 0.99, i


def test_programs_are_registered_and_need_a_card(work, tmp_path,
                                                 monkeypatch):
    for name in ("transform_filter", "transform_normalize",
                 "transform_geometry", "image_align"):
        assert name in list_programs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, extra in (("transform_filter", ["--fourier", "low_pass",
                                              "0.2"]),
                        ("transform_normalize", []),
                        ("transform_geometry", ["--rotate", "10"]),
                        ("image_align", [])):
        out = str(tmp_path / f"{name}.mrcs")
        with pytest.raises(RuntimeError, match="--device cpu"):
            get_program(name).run_with_args(
                ["-i", f"{work}/views.mrcs", "-o", out] + extra)
        assert not os.path.exists(out)
