"""The port's copies of the host I/O modules against the reference's: the
images and metadata one package writes, the other reads back unchanged.
The image formats that wait for a later slice raise a clear error."""
import numpy as np
import pytest

from xmipp3_tpu.core import image as jimage
from xmipp3_tpu.core.metadata import MetaData as JMetaData
from xmipp3_tpu_torch.core import image as timage
from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.metadata import MetaData


@pytest.mark.parametrize("name,shape", [
    ("stack.mrcs", (3, 16, 16)), ("vol.mrc", (8, 16, 16)),
    ("stack.stk", (3, 16, 16)), ("vol.vol", (8, 16, 16)),
    ("img.spi", (16, 16)), ("img.tif", (16, 16))])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_images_round_trip_between_the_packages(tmp_path, name, shape,
                                                writer):
    data = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    path = str(tmp_path / name)
    save, load = ((timage.save_image, jimage.Image) if writer == "port"
                  else (jimage.save_image, timage.Image))
    save(path, data)
    np.testing.assert_array_equal(np.squeeze(load(path).data), data)


def test_stack_rows_read_one_by_one(tmp_path):
    data = np.random.default_rng(5).standard_normal(
        (4, 12, 12)).astype(np.float32)
    path = str(tmp_path / "s.mrcs")
    jimage.save_image(path, data)
    for i in range(4):
        np.testing.assert_array_equal(
            np.squeeze(timage.Image(f"{i + 1}@{path}").data), data[i])
    np.testing.assert_array_equal(timage.Image.read_stack(path), data)
    np.testing.assert_array_equal(timage.Image.read_slices(path, [2, 0]),
                                  data[[2, 0]])


@pytest.mark.parametrize("name", ["a.em", "a.hdf5", "a.img"])
def test_formats_of_a_later_slice_raise(tmp_path, name):
    with pytest.raises(XmippError, match="not yet ported") as err:
        timage.save_image(str(tmp_path / name), np.zeros((4, 4), np.float32))
    assert err.value.code == ErrCode.NOT_IMPLEMENTED


def test_metadata_written_by_the_port_reads_in_the_reference(tmp_path):
    rows = [{"image": f"{i + 1}@parts.mrcs", "angleRot": 10.5 * i,
             "angleTilt": 3.25, "shiftX": -1.5, "weight": 0.5, "flip": i % 2}
            for i in range(5)]
    fn = str(tmp_path / "parts.xmd")
    MetaData.fromRows(rows).write(fn)
    theirs = JMetaData(fn)
    assert theirs.size() == 5
    for i, oid in enumerate(theirs):
        row = theirs.getRow(oid)
        for key, value in rows[i].items():
            assert row[key] == value
