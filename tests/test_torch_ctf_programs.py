"""ctf_phase_flip and ctf_correct_wiener2d of the port against the
reference's programs, and the port's XmippMetadataProgram (N=32, CPU).

Held to: phase-flipped images 1e-4 * max (a sample at a CTF zero crossing
may take the other sign in the other package; test_torch_ctf.py holds the
sign tables), Wiener-corrected images 1e-5 * max; the output metadata rows
equal (image names up to the output's own path). The program evaluates a
batch's per-row CTFs in one pass, and equals the one-image-at-a-time form
to 1e-6 * max. XmippMetadataProgram: every output mode of the reference's
(a stack, a metadata beside a stack, --oroot images, in place,
--save_metadata_stack), --resume, and the native geometry on read (the
reference's to 1e-5 * max), and the reference's readApplyGeo convention on
read (--geo_convention xmipp, B-spline; the reference's to 1e-5 * max).
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.core.metadata_program import \
    XmippMetadataProgram as JaxMetadataProgram
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import (XmippMetadataProgram,
                                                    is_metadata_file)
from xmipp3_tpu_torch.ops.ctf import CTFDescription, phase_flip
from xmipp3_tpu_torch.programs import get_program
from xmipp3_tpu_torch.programs.ctf_correct import _row_ctf

torch.set_num_threads(1)
N, B = 32, 6
SIDES = (("ref", jax_program, []), ("port", get_program, ["--device", "cpu"]))
TOL = {"ctf_phase_flip": 1e-4, "ctf_correct_wiener2d": 1e-5}


def _ctf(k):
    return CTFDescription(sampling_rate=2.0, voltage=300, Cs=2.7, Q0=0.1,
                          defocusU=9000 + 1500 * k, defocusV=9400 + 1500 * k,
                          azimuthal_angle=25.0 * k)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A stack, a metadata naming it with inline CTF labels on half the
    rows and ctfModel files on the other half, and one .ctfparam."""
    d = tmp_path_factory.mktemp("ctfprog")
    rng = np.random.default_rng(41)
    imgs = rng.standard_normal((B, N, N)).astype(np.float32)
    save_image(str(d / "parts.mrcs"), imgs)
    _ctf(0).write(str(d / "one.ctfparam"))
    rows = []
    for i in range(B):
        row = {"image": f"{i + 1:06d}@{d}/parts.mrcs", "itemId": i + 1}
        if i % 2:
            fn = str(d / f"m{i}.ctfparam")
            _ctf(i).write(fn)
            row["ctfModel"] = fn
        else:
            row.update({lbl: float(getattr(_ctf(i), a)) for a, lbl in
                        CTFDescription._MD_MAP.items()})
        rows.append(row)
    MetaData.fromRows(rows).write(str(d / "parts.xmd"))
    return d, imgs


CASES = {
    "flip_file_stack": ("ctf_phase_flip", "stack",
                        "--ctf {d}/one.ctfparam"),
    "flip_rows_md": ("ctf_phase_flip", "md", ""),
    "flip_file_downsampled": ("ctf_phase_flip", "stack",
                              "--ctf {d}/one.ctfparam --downsampling 1.5"),
    "flip_rows_sampling": ("ctf_phase_flip", "md", "--sampling 2.5"),
    "wiener_file_stack": ("ctf_correct_wiener2d", "stack",
                          "--ctf {d}/one.ctfparam --pad 2"),
    "wiener_rows_md": ("ctf_correct_wiener2d", "md",
                       "--pad 1 --wc 0.05 --isIsotropic"),
    "wiener_rows_flipped": ("ctf_correct_wiener2d", "md",
                            "--phase_flipped --correct_envelope "
                            "--sampling_rate 2.2"),
}


def _out(o, kind):
    if kind == "stack":
        return np.squeeze(Image(str(o / "out.mrcs")).data), None
    md = MetaData(str(o / "out.xmd"))
    rows = [md.getRow(i) for i in md]
    return np.stack([np.squeeze(Image(r["image"]).data) for r in rows]), rows


@pytest.mark.parametrize("case", list(CASES))
def test_ctf_programs_match_the_reference(data, tmp_path, case):
    d, imgs = data
    program, kind, flags = CASES[case]
    src = f"{d}/parts.mrcs" if kind == "stack" else f"{d}/parts.xmd"
    got = {}
    for side, prog, dev in SIDES:
        o = tmp_path / side
        o.mkdir()
        args = ["-i", src, "-o", str(o / "out.mrcs")] + (
            ["--save_metadata_stack", str(o / "out.xmd")]
            if kind == "md" else []) + flags.format(d=d).split() + dev
        assert prog(program).run_with_args(args + ["-v", "0"]) == 0
        got[side] = _out(o, kind)
    (port, prow), (ref, rrow) = got["port"], got["ref"]
    assert port.shape == ref.shape == imgs.shape
    assert rel_err(port, ref) <= TOL[program]
    assert rel_err(port, imgs) > 1e-3             # the images changed
    if prow is not None:
        strip = lambda rows: [{k: v for k, v in r.items() if k != "image"}
                              for r in rows]
        assert strip(prow) == strip(rrow)


def test_ctf_correct_phase_is_the_alias_of_ctf_phase_flip(data, tmp_path):
    d, _ = data
    for name in ("ctf_correct_phase", "ctf_phase_flip"):
        assert get_program(name).run_with_args(
            ["-i", f"{d}/parts.xmd", "-o", str(tmp_path / f"{name}.mrcs"),
             "--device", "cpu", "-v", "0"]) == 0
    np.testing.assert_array_equal(
        Image(str(tmp_path / "ctf_correct_phase.mrcs")).data,
        Image(str(tmp_path / "ctf_phase_flip.mrcs")).data)


def test_batched_per_row_ctfs_equal_one_image_at_a_time(data, tmp_path):
    """The program evaluates a batch's per-row CTFs in one pass; the
    reference's form, one image at a time, gives the same images."""
    d, imgs = data
    assert get_program("ctf_phase_flip").run_with_args(
        ["-i", f"{d}/parts.xmd", "-o", str(tmp_path / "out.mrcs"),
         "--device", "cpu", "-v", "0"]) == 0
    got = np.squeeze(Image(str(tmp_path / "out.mrcs")).data)
    md = MetaData(f"{d}/parts.xmd")
    for i, r in enumerate(md.getRow(k) for k in md):
        one = phase_flip(imgs[i], _row_ctf(r), device="cpu").numpy()
        assert np.abs(got[i] - one).max() <= 1e-6 * np.abs(one).max()


# -- XmippMetadataProgram -----------------------------------------------------

class _Scale(XmippMetadataProgram):
    """A test program: doubles every image; applies the rows' geometry on
    read (apply_geo)."""
    name = "xmipp_scale_test"
    apply_geo = True
    batch_size = 4

    def processBatch(self, imgs, rows):
        return 2.0 * torch.as_tensor(imgs, device=self.device)


class _JaxScale(JaxMetadataProgram):
    name = "xmipp_scale_test"
    apply_geo = True
    batch_size = 4

    def processBatch(self, imgs, rows):
        return 2.0 * np.asarray(imgs)


def _run(cls, args, dev=()):
    assert cls().run_with_args(list(args) + list(dev) + ["-v", "0"]) == 0


@pytest.fixture
def posed(tmp_path):
    """A stack and a metadata with poses (psi, shifts, flips)."""
    rng = np.random.default_rng(43)
    imgs = rng.standard_normal((B, N, N)).astype(np.float32)
    save_image(str(tmp_path / "in.mrcs"), imgs)
    MetaData.fromRows(
        {"image": f"{i + 1:06d}@{tmp_path}/in.mrcs", "itemId": i + 1,
         "anglePsi": 17.0 * i, "shiftX": 0.7 * i, "shiftY": -0.4 * i,
         "flip": i % 2} for i in range(B)).write(str(tmp_path / "in.xmd"))
    return tmp_path, imgs


def test_metadata_program_output_modes(posed):
    d, imgs = posed
    dev = ["--device", "cpu"]
    # a stack in, a stack out
    _run(_Scale, ["-i", f"{d}/in.mrcs", "-o", f"{d}/s.mrcs"], dev)
    np.testing.assert_array_equal(np.squeeze(Image(f"{d}/s.mrcs").data),
                                  2 * imgs)
    # --dont_apply_geo: a metadata in, a stack out, the table saved
    _run(_Scale, ["-i", f"{d}/in.xmd", "-o", f"{d}/m.mrcs",
                  "--dont_apply_geo", "--save_metadata_stack",
                  f"{d}/m_out.xmd"], dev)
    md = MetaData(f"{d}/m_out.xmd")
    rows = [md.getRow(i) for i in md]
    assert [r["image"] for r in rows] == [f"{i + 1:06d}@{d}/m.mrcs"
                                          for i in range(B)]
    assert [r["itemId"] for r in rows] == list(range(1, B + 1))
    np.testing.assert_array_equal(np.squeeze(Image(f"{d}/m.mrcs").data),
                                  2 * imgs)
    # --oroot: one image a row
    _run(_Scale, ["-i", f"{d}/in.mrcs", "--oroot", f"{d}/img_"], dev)
    np.testing.assert_array_equal(
        np.squeeze(Image(f"{d}/img_000003.mrc").data), 2 * imgs[2])
    # in place, over the input stack
    save_image(f"{d}/ip.mrcs", imgs)
    _run(_Scale, ["-i", f"{d}/ip.mrcs"], dev)
    np.testing.assert_array_equal(np.squeeze(Image(f"{d}/ip.mrcs").data),
                                  2 * imgs)
    # a metadata out: the reference's rows, no images written
    _run(_Scale, ["-i", f"{d}/in.xmd", "-o", f"{d}/rows.xmd",
                  "--dont_apply_geo"], dev)
    assert [r["image"] for r in (lambda m: [m.getRow(i) for i in m])(
        MetaData(f"{d}/rows.xmd"))] == [f"{i + 1:06d}@{d}/in.mrcs"
                                        for i in range(B)]
    # a single image
    save_image(f"{d}/one.xmp", imgs[0])
    _run(_Scale, ["-i", f"{d}/one.xmp", "-o", f"{d}/one_out.xmp"], dev)
    np.testing.assert_array_equal(np.squeeze(Image(f"{d}/one_out.xmp").data),
                                  2 * imgs[0])
    assert is_metadata_file(f"{d}/in.xmd") and is_metadata_file("x.ctfparam")
    assert not is_metadata_file(f"{d}/in.mrcs")


def test_metadata_program_applies_geometry_as_the_reference(posed):
    d, _ = posed
    _run(_Scale, ["-i", f"{d}/in.xmd", "-o", f"{d}/port.mrcs"],
         ["--device", "cpu"])
    _run(_JaxScale, ["-i", f"{d}/in.xmd", "-o", f"{d}/ref.mrcs"])
    port = np.squeeze(Image(f"{d}/port.mrcs").data)
    ref = np.squeeze(Image(f"{d}/ref.mrcs").data)
    assert rel_err(port, ref) <= 1e-5
    raw = np.squeeze(Image(f"{d}/in.mrcs").data)
    assert rel_err(port, 2 * raw) > 1e-2          # the geometry was applied


def test_metadata_program_resume(posed):
    d, imgs = posed
    _run(_Scale, ["-i", f"{d}/in.xmd", "-o", f"{d}/out.xmd",
                  "--dont_apply_geo"], ["--device", "cpu"])
    md = MetaData(f"{d}/out.xmd")
    keep = md.df[md.df["itemId"] <= 2]
    MetaData(keep.reset_index(drop=True)).write(f"{d}/out.xmd")
    seen = []

    class Counting(_Scale):
        def processBatch(self, imgs, rows):
            seen.extend(r["itemId"] for r in rows)
            return super().processBatch(imgs, rows)

    _run(Counting, ["-i", f"{d}/in.xmd", "-o", f"{d}/out.xmd",
                    "--dont_apply_geo", "--resume"], ["--device", "cpu"])
    assert seen == list(range(3, B + 1))
    md = MetaData(f"{d}/out.xmd")
    assert list(md.getColumn("itemId")) == list(range(1, B + 1))


def test_geo_convention_xmipp_raises_naming_the_queue(posed):
    """--geo_convention xmipp applies the rows as the reference's
    readApplyGeo does (it raised until read_apply_geo was ported)."""
    d, _ = posed
    args = ["-i", f"{d}/in.xmd", "--geo_convention", "xmipp"]
    _run(_Scale, args + ["-o", f"{d}/x.mrcs"], ["--device", "cpu"])
    _run(_JaxScale, args + ["-o", f"{d}/x_ref.mrcs"])
    port = np.squeeze(Image(f"{d}/x.mrcs").data)
    assert rel_err(port, np.squeeze(Image(f"{d}/x_ref.mrcs").data)) <= 1e-5
    native = f"{d}/native.mrcs"
    _run(_Scale, ["-i", f"{d}/in.xmd", "-o", native], ["--device", "cpu"])
    assert rel_err(port, np.squeeze(Image(native).data)) > 1e-2
    # not applying the geometry, the convention is moot
    _run(_Scale, ["-i", f"{d}/in.xmd", "-o", f"{d}/x.mrcs",
                  "--geo_convention", "xmipp", "--dont_apply_geo"],
         ["--device", "cpu"])


def test_ctf_programs_raise_without_a_card(data, tmp_path, monkeypatch):
    d, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("ctf_phase_flip", "ctf_correct_wiener2d",
                 "resolution_fsc"):
        args = (["--ref", f"{d}/parts.mrcs", "-i", f"{d}/parts.mrcs"]
                if name == "resolution_fsc" else
                ["-i", f"{d}/parts.xmd", "-o", str(tmp_path / "o.mrcs")])
        with pytest.raises(RuntimeError, match="--device cpu"):
            get_program(name).run_with_args(args)
    assert not list(tmp_path.iterdir())
