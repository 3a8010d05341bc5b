"""The slice as a whole: the port's angular_project_library and
angular_projection_matching programs against the reference's on the same
files, the port with --device cpu (N=32, 15-degree gallery).

Held to: gallery stack <= 1e-4 * max and identical .doc / sampling /
neighbour files; assignment rows to the tolerances of test_torch_match.py
(same ref and flip, counting the exact antipodal-mirror tie as the same
direction, for >= 98 % of the rows; on the same rows psi <= 0.5 deg, shifts
<= 0.05 px, maxCC <= 1e-3). The flags of later slices raise with the
ROADMAP queue's name; --method real_space is accepted and ignored, as in the
reference."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import REPO, rel_err
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.sampling import directions_from_angles
from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
from xmipp3_tpu_torch.programs import get_program, main

torch.set_num_threads(1)
N, B = 32, 24
SIDES = (("ref", jax_program, []), ("port", get_program, ["--device", "cpu"]))


def _rows(fn):
    md = MetaData(str(fn))
    return [md.getRow(i) for i in md]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A volume, both packages' default galleries of it, and a particle set
    made from the reference's gallery (rotated, shifted, noisy)."""
    d = tmp_path_factory.mktemp("match")
    vol = d / "vol.vol"
    save_image(str(vol), phantom8(N))
    for side, prog, dev in SIDES:
        args = ["-i", str(vol), "-o", str(d / side), "--sampling_rate", "15",
                "--compute_neighbors", "--angular_distance", "25"] + dev
        assert prog("angular_project_library").run_with_args(args) == 0
    refs = np.squeeze(Image(str(d / "ref.stk")).data)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(refs), B)
    imgs = apply_alignment_2d(
        refs[idx], rng.uniform(-180, 180, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32), device="cpu").numpy()
    imgs += 0.1 * refs.std() * rng.standard_normal(imgs.shape).astype(
        np.float32)
    stk = d / "parts.mrcs"
    save_image(str(stk), imgs)
    gal = _rows(d / "ref.doc")
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": gal[idx[i]]["angleRot"],
         "angleTilt": gal[idx[i]]["angleTilt"], "anglePsi": 0.0,
         "itemId": i + 1} for i in range(B)).write(str(d / "parts.xmd"))
    # per-particle neighbour lists, keyed by the particle's image name
    near = _rows(d / "ref_neighbors.xmd")
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "neighbors": near[idx[i]]["neighbors"]}
        for i in range(B)).write(str(d / "parts_neighbors.xmd"))
    return d


def test_gallery_matches_the_reference(work):
    ref = np.squeeze(Image(str(work / "ref.stk")).data)
    port = np.squeeze(Image(str(work / "port.stk")).data)
    assert port.shape == ref.shape == (len(_rows(work / "ref.doc")), N, N)
    assert rel_err(port, ref) <= 1e-4
    for suffix in (".doc", "_sampling.xmd", "_neighbors.xmd"):
        a = (work / f"ref{suffix}").read_text().replace("ref.stk", "X")
        b = (work / f"port{suffix}").read_text().replace("port.stk", "X")
        assert a == b, suffix


@pytest.mark.parametrize("extra", [
    ["--psi_sampling", "120", "--sym", "c3", "--max_tilt_angle", "90"],
    ["--perturb", "0.02", "--min_tilt_angle", "30", "--batch", "50"],
    ["--experimental_images", "{d}/parts.xmd", "--near_exp_data",
     "--closer_sampling_points", "--angular_distance", "20",
     "--compute_neighbors", "--only_winner"]])
def test_gallery_options_match_the_reference(work, tmp_path, extra):
    extra = [a.format(d=work) for a in extra]
    for side, prog, dev in SIDES:
        args = ["-i", str(work / "vol.vol"), "-o", str(tmp_path / side),
                "--sampling_rate", "20"] + extra + dev
        assert prog("angular_project_library").run_with_args(args) == 0
    ref = np.squeeze(Image(str(tmp_path / "ref.stk")).data)
    port = np.squeeze(Image(str(tmp_path / "port.stk")).data)
    assert port.shape == ref.shape
    assert rel_err(port, ref) <= 1e-4
    written = sorted(p.name[3:] for p in tmp_path.glob("ref*") if
                     p.suffix != ".stk")
    assert written == sorted(p.name[4:] for p in tmp_path.glob("port*")
                             if p.suffix != ".stk")
    for suffix in written:
        a = (tmp_path / f"ref{suffix}").read_text().replace("ref.stk", "X")
        b = (tmp_path / f"port{suffix}").read_text().replace("port.stk", "X")
        assert a == b, suffix


def _hold_rows(got, want, gallery):
    assert len(got) == len(want)
    col = lambda rows, k: np.array([float(r[k]) for r in rows])
    ref_g, ref_w = (col(r, "ref").astype(int) - 1 for r in (got, want))
    flip_g, flip_w = col(got, "flip"), col(want, "flip")
    same = (ref_g == ref_w) & (flip_g == flip_w)
    d = directions_from_angles(np.array(
        [[r["angleRot"], r["angleTilt"]] for r in gallery], float))
    tie = ~same & (flip_g != flip_w) & ((d[ref_g] * d[ref_w]).sum(-1) < -0.9999)
    assert (same | tie).mean() >= 0.98
    assert same.mean() >= 0.8
    dpsi = np.abs((col(got, "anglePsi") - col(want, "anglePsi") + 180) % 360
                  - 180)
    assert dpsi[same].max() <= 0.5
    for k in ("shiftX", "shiftY"):
        assert np.abs(col(got, k) - col(want, k))[same].max() <= 0.05
    assert np.abs(col(got, "maxCC") - col(want, "maxCC"))[same | tie].max() \
        <= 1e-3
    for k in ("angleRot", "angleTilt"):
        assert np.abs(col(got, k) - col(want, k))[same].max() <= 1e-4
    for g, w in zip(got, want):
        assert g["image"] == w["image"] and g["itemId"] == w["itemId"]
        assert set(g) == set(w)


@pytest.mark.parametrize("extra", [
    [], ["--number_orientations", "2", "--batch", "16"],
    ["--neighbors", "{d}/parts_neighbors.xmd"],
    ["--max_angular_change", "40", "--sym", "c2", "--search5d_step", "2"],
    ["--scale", "2", "1", "--Ri", "3", "--Ro", "12"]])
def test_matching_matches_the_reference(work, tmp_path, extra):
    extra = [a.format(d=work) for a in extra]
    for side, prog, dev in SIDES:
        dev = dev or ["--mesh", "none"]     # the reference on its serial path
        args = ["-i", str(work / "parts.xmd"), "-o",
                str(tmp_path / f"{side}.xmd"), "--ref", str(work / "ref"),
                "--max_shift", "4"] + extra + dev
        assert prog("angular_projection_matching").run_with_args(args) == 0
    _hold_rows(_rows(tmp_path / "port.xmd"), _rows(tmp_path / "ref.xmd"),
               _rows(work / "ref.doc"))


def _ctf_file(d, kind):
    """A --ctf input: a .ctfparam file (a CTF with zeros in the band, so
    that --phase_flipped changes the gallery), or the centred 2-D
    amplitude image of the same CTF."""
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    ctf = CTFDescription(sampling_rate=2.0, voltage=300, Cs=2.7, Q0=0.1,
                         defocusU=9000, defocusV=9600, azimuthal_angle=30)
    if kind == "ctfparam":
        fn = str(d / "g.ctfparam")
        ctf.write(fn)
        return fn
    fn = str(d / "amp.xmp")
    save_image(fn, np.abs(ctf.generate_2d(N, N, rfft_layout=False,
                                          device="cpu").numpy()))
    return fn


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("kind", ["ctfparam", "amplitude"])
def test_matching_with_ctf_matches_the_reference(work, tmp_path, kind,
                                                 flipped):
    """--ctf multiplies the gallery by the file's CTF (a .ctfparam, in
    absolute value under --phase_flipped) or by a 2-D amplitude image."""
    extra = ["--ctf", _ctf_file(tmp_path, kind)] + (
        ["--phase_flipped"] if flipped else [])
    for side, prog, dev in SIDES:
        dev = dev or ["--mesh", "none"]
        args = ["-i", str(work / "parts.xmd"), "-o",
                str(tmp_path / f"{side}.xmd"), "--ref", str(work / "ref"),
                "--max_shift", "4"] + extra + dev
        assert prog("angular_projection_matching").run_with_args(args) == 0
    got = _rows(tmp_path / "port.xmd")
    _hold_rows(got, _rows(tmp_path / "ref.xmd"), _rows(work / "ref.doc"))
    # the CTF reached the gallery: the scores differ from a plain run's
    assert get_program("angular_projection_matching").run_with_args(
        ["-i", str(work / "parts.xmd"), "-o", str(tmp_path / "plain.xmd"),
         "--ref", str(work / "ref"), "--max_shift", "4", "--device",
         "cpu"]) == 0
    plain = _rows(tmp_path / "plain.xmd")
    assert max(abs(g["maxCC"] - p["maxCC"]) for g, p in zip(got, plain)) \
        > 1e-3


def test_both_programs_through_the_dispatcher(work, tmp_path):
    """`python -m xmipp3_tpu_torch.programs` in a process of its own, which
    never imports jax or the reference package. It runs on one thread, as
    this process does, so that its FFTs sum in the same order."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "xmipp3_tpu_torch.programs", *a, "--device",
         "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    out = run("angular_project_library", "-i", str(work / "vol.vol"), "-o",
              "g", "--sampling_rate", "15")
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(Image(str(tmp_path / "g.stk")).data,
                                  Image(str(work / "port.stk")).data)
    out = run("angular_projection_matching", "-i", str(work / "parts.xmd"),
              "-o", "a.xmd", "--ref", "g.doc", "--max_shift", "4", "-v", "2")
    assert out.returncode == 0, out.stderr
    assert "match_to_gallery" in out.stdout + out.stderr   # phase timing
    assert len(_rows(tmp_path / "a.xmd")) == B
    assert main(["xmipp", "--help"]) == 0


def test_programs_raise_without_a_card(work, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        get_program("angular_project_library").run_with_args(
            ["-i", str(work / "vol.vol"), "-o", str(tmp_path / "g")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        get_program("angular_projection_matching").run_with_args(
            ["-i", str(work / "parts.xmd"), "-o", str(tmp_path / "a.xmd"),
             "--ref", str(work / "port")])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("program,flag", [
    ("angular_project_library", ["--method", "real_space"]),
    ("angular_projection_matching", ["--ctf", "{d}/g.ctfparam"]),
    ("angular_projection_matching", ["--mesh", "dp"]),
    ("angular_projection_matching", ["--mesh", "tp"]),
    ("angular_projection_matching", ["--dist_nprocs", "2"])])
def test_flags_of_later_slices_raise(work, tmp_path, program, flag):
    """--ctf is ported: a .ctfparam file gives the reference's rows (see
    test_matching_with_ctf_matches_the_reference). --method real_space is
    accepted and ignored as in the reference (the gallery is the
    reference's under the same flag). On one device the mesh flags
    behave as in the reference: --mesh dp|tp need two ranks, and
    --dist_nprocs without --dist_coordinator leaves the run serial
    (tests/test_torch_parallel.py runs the mesh paths on ranks)."""
    args = {"angular_project_library":
            ["-i", str(work / "vol.vol"), "-o", str(tmp_path / "g")],
            "angular_projection_matching":
            ["-i", str(work / "parts.xmd"), "-o", str(tmp_path / "a.xmd"),
             "--ref", str(work / "port")]}[program]
    run = lambda extra: get_program(program).run_with_args(
        args + ["--device", "cpu"] + extra)
    if flag[0] == "--ctf":
        _ctf_file(tmp_path, "ctfparam")
        flag = [flag[0], flag[1].format(d=tmp_path)]
        assert run(flag) == 0
        assert jax_program(program).run_with_args(
            args[:2] + ["-o", str(tmp_path / "r.xmd"), "--ref",
                        str(work / "ref"), "--mesh", "none"] + flag) == 0
        _hold_rows(_rows(tmp_path / "a.xmd"), _rows(tmp_path / "r.xmd"),
                   _rows(work / "ref.doc"))
    elif flag[0] == "--method":
        flag = flag + ["--sampling_rate", "15"]
        assert run(flag) == 0
        assert jax_program(program).run_with_args(
            ["-i", str(work / "vol.vol"), "-o", str(tmp_path / "r")]
            + flag) == 0
        for suffix in (".doc", "_sampling.xmd"):
            assert (tmp_path / f"g{suffix}").read_text().replace(
                "g.stk", "X") == (tmp_path / f"r{suffix}").read_text() \
                .replace("r.stk", "X")
        assert rel_err(np.squeeze(Image(str(tmp_path / "g.stk")).data),
                       np.squeeze(Image(str(tmp_path / "r.stk")).data)) \
            <= 1e-4
    elif flag[0] == "--mesh":
        with pytest.raises(RuntimeError, match="needs >= 2 devices"):
            run(flag)
        assert not list(tmp_path.iterdir())
    else:
        assert run(flag) == 0
        serial = _rows(tmp_path / "a.xmd")
        assert run([]) == 0
        assert _rows(tmp_path / "a.xmd") == serial
