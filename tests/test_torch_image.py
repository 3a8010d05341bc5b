"""The port's copies of the host I/O modules against the reference's: the
images and metadata one package writes, the other reads back unchanged,
in the formats of core/image.py and of core/image_formats.py
(tests/test_torch_image_formats.py has the rest of the codecs' cases)."""
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
    """These formats raised until core/image_formats.py was ported: now the
    port writes them and the reference reads them back; an unknown format
    still raises."""
    data = np.random.default_rng(3).standard_normal((4, 4)).astype(
        np.float32)
    timage.save_image(str(tmp_path / name), data)
    np.testing.assert_array_equal(
        np.squeeze(jimage.Image(str(tmp_path / name)).data), data)
    with pytest.raises(XmippError) as err:
        timage.save_image(str(tmp_path / "a.nope"), data)
    assert err.value.code == ErrCode.IMG_NOWRITE


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


@pytest.mark.parametrize("name", ["s.mrcs", "s.stk", "v.mrc"])
@pytest.mark.parametrize("indices", [
    [0, 1, 2, 3, 4, 5, 6], [2, 3, 4], [5, 0, 3], [1, 2, 6, 7, 8, 4, 4, 5],
    [8]])
def test_read_slices_equals_the_slice_by_slice_read(tmp_path, name, indices):
    """Runs of consecutive slices are fetched with one read each; the
    arrays are those of the slice-by-slice read, bit for bit."""
    data = np.random.default_rng(6).standard_normal(
        (9, 10, 14)).astype(np.float32)
    path = str(tmp_path / name)
    timage.save_image(path, data)
    one_by_one = np.stack([np.squeeze(timage.Image(f"{i + 1}@{path}").data)
                           for i in indices])
    got = timage.Image.read_slices(path, indices)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, one_by_one)
    np.testing.assert_array_equal(got, data[indices])
    np.testing.assert_array_equal(got, jimage.Image.read_slices(path, indices))


def test_read_slices_of_other_dtypes_and_out_of_range(tmp_path):
    data = np.random.default_rng(7).integers(-100, 100, (5, 6, 8)).astype(
        np.int16)
    path = str(tmp_path / "i.mrcs")
    timage.write_mrc(path, data, dtype=np.int16)
    got = timage.Image.read_slices(path, [1, 2, 4])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, data[[1, 2, 4]].astype(np.float32))
    with pytest.raises(XmippError):
        timage.Image.read_slices(path, [3, 5])
    # a format without the run reader still goes slice by slice
    tif = str(tmp_path / "a.tif")
    timage.save_image(tif, data[0].astype(np.float32))
    np.testing.assert_array_equal(timage.Image.read_slices(tif, [0])[0],
                                  data[0])


def test_load_image_rows_and_prefetcher(tmp_path):
    from xmipp3_tpu.core import metadata_program as jmp
    from xmipp3_tpu_torch.core import metadata_program as tmp
    rng = np.random.default_rng(8)
    a = rng.standard_normal((6, 8, 8)).astype(np.float32)
    b = rng.standard_normal((4, 8, 8)).astype(np.float32)
    pa, pb, pc = (str(tmp_path / n) for n in ("a.mrcs", "b.stk", "c.spi"))
    timage.save_image(pa, a)
    timage.save_image(pb, b)
    timage.save_image(pc, a[0])
    names = ([f"{i + 1}@{pa}" for i in (0, 1, 2, 5, 4)] + [pc]
             + [f"{i + 1:06d}@{pb}" for i in (3, 0, 1, 2)] + [f"3@{pa}"])
    rows = [{"image": n, "k": i} for i, n in enumerate(names)]
    want = np.stack([a[0], a[1], a[2], a[5], a[4], a[0], b[3], b[0], b[1],
                     b[2], a[2]])
    got = tmp.load_image_rows(rows)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jmp.load_image_rows(rows))
    seen = list(tmp.BatchPrefetcher(rows, 4))
    assert [s for s, _, _ in seen] == [0, 4, 8]
    assert [len(c) for _, c, _ in seen] == [4, 4, 3]
    np.testing.assert_array_equal(np.concatenate([i for _, _, i in seen]),
                                  want)
    with pytest.raises(XmippError):
        list(tmp.BatchPrefetcher([{"image": f"1@{tmp_path}/none.mrcs"}], 2))
