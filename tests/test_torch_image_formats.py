"""The port's image-format codecs (core/image_formats.py, dispatched by
core/image.py) against the reference package's: each format the port
writes reads back bit for bit (float32 formats; PIF and JPEG/PNG quantize
by design and must read what the reference's codec reads), each file the
reference's codec writes reads the same in the port, and the reverse.
h5py and PIL are imported only when their codecs run.
"""
import subprocess
import sys

import numpy as np
import pytest

from test_torch_common import REPO
from xmipp3_tpu.core import image as jimage
from xmipp3_tpu.core import image_formats as jfmt
from xmipp3_tpu_torch.core import image as timage
from xmipp3_tpu_torch.core import image_formats as tfmt
from xmipp3_tpu_torch.core.errors import XmippError

EXACT = [("stack.img", (3, 16, 12)), ("one.hed", (16, 12)),
         ("vol.em", (5, 16, 12)), ("img.em", (16, 12)),
         ("stack.ser", (3, 16, 12)), ("one.ser", (16, 12)),
         ("stack.h5", (3, 16, 12)), ("img.hdf5", (16, 12))]
QUANTIZED = [("stack.pif", (3, 16, 12)), ("img.pif", (16, 12)),
             ("img.png", (16, 12)), ("img.jpg", (16, 12))]


def _data(shape, seed=4):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name,shape", EXACT)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_float_formats_round_trip_between_the_packages(tmp_path, name, shape,
                                                       writer):
    data = _data(shape)
    path = str(tmp_path / name)
    save = timage.save_image if writer == "port" else jimage.save_image
    save(path, data)
    for load in (timage.Image, jimage.Image):
        np.testing.assert_array_equal(np.squeeze(load(path).data), data)
    hdr = timage.Image()
    hdr.read(path, header_only=True)
    assert hdr.header.shape == jimage.Image().read(
        path, header_only=True).header.shape


@pytest.mark.parametrize("name,shape", QUANTIZED)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_quantized_formats_read_as_the_reference_reads(tmp_path, name,
                                                       shape, writer):
    data = _data(shape)
    path = str(tmp_path / name)
    (timage.save_image if writer == "port" else jimage.save_image)(path,
                                                                   data)
    ours = np.squeeze(timage.Image(path).data)
    np.testing.assert_array_equal(ours, np.squeeze(jimage.Image(path).data))
    assert ours.shape == data.shape
    assert np.corrcoef(ours.ravel(), data.ravel())[0, 1] > 0.9


def test_files_are_written_byte_for_byte_as_the_reference(tmp_path):
    data = _data((3, 16, 12))
    for ext in ("img", "em", "ser", "pif"):
        a, b = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        timage.save_image(str(a), data)
        jimage.save_image(str(b), data)
        assert a.read_bytes() == b.read_bytes(), ext
    assert (tmp_path / "a.hed").read_bytes() == \
        (tmp_path / "b.hed").read_bytes()


def test_stack_slices_of_imagic_and_pif(tmp_path):
    data = _data((4, 10, 8))
    for name in ("s.img", "s.pif"):
        path = str(tmp_path / name)
        jimage.save_image(path, data)
        for i in range(4):
            np.testing.assert_array_equal(
                np.squeeze(timage.Image(f"{i + 1}@{path}").data),
                np.squeeze(jimage.Image(f"{i + 1}@{path}").data))


def _dm3(path, data):
    """A minimal DM3 tag tree with one ImageList entry (the layout the
    reference codec parses)."""
    import struct
    ny, nx = data.shape

    def tag_data(name, defn, payload):
        out = b"\x15" + struct.pack(">h", len(name)) + name.encode()
        out += b"%%%%" + struct.pack(">i", len(defn))
        out += b"".join(struct.pack(">i", d) for d in defn)
        return out + payload

    def tag_dir(name, body, n):
        return (b"\x14" + struct.pack(">h", len(name)) + name.encode()
                + b"\x00\x00" + struct.pack(">i", n) + body)

    dims = (tag_data("", [3], struct.pack("<i", nx))
            + tag_data("", [3], struct.pack("<i", ny)))
    image_data = (tag_data("Data", [20, 6, nx * ny],
                           data.astype("<f4").tobytes())
                  + tag_dir("Dimensions", dims, 2))
    entry = tag_dir("", tag_dir("ImageData", image_data, 2), 1)
    root = tag_dir("ImageList", entry, 1)
    with open(path, "wb") as f:
        f.write(struct.pack(">iii", 3, 0, 1) + b"\x00\x00"
                + struct.pack(">i", 1) + root)


def test_dm3_reads_as_the_reference_reads(tmp_path):
    data = _data((6, 7))
    path = str(tmp_path / "img.dm3")
    _dm3(path, data)
    ours = timage.Image(path).data
    np.testing.assert_array_equal(ours, jimage.Image(path).data)
    np.testing.assert_array_equal(ours, data)


def test_bad_files_raise_as_the_reference(tmp_path):
    for name in ("x.em", "x.ser", "x.pif", "x.dm3"):
        path = tmp_path / name
        path.write_bytes(b"\x00" * 600)
        with pytest.raises(XmippError):
            timage.Image(str(path))
        with pytest.raises(Exception):
            jimage.Image(str(path))
    with pytest.raises(XmippError):
        tfmt.write_pil(str(tmp_path / "x.png"), _data((2, 4, 4)))


def test_h5py_and_pil_are_imported_lazily():
    probe = ("import sys, xmipp3_tpu_torch.core.image_formats, "
             "xmipp3_tpu_torch.core.image; "
             "print(sorted(m for m in ('h5py', 'PIL') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert tfmt.read_imagic.__doc__ == jfmt.read_imagic.__doc__
