"""Extended image-format codecs: Imagic, EM, SER (FEI TIA), DM3/DM4
(Digital Micrograph), PIF, HDF5, JPEG/PNG.

A copy of the reference package's core/image_formats.py (host numpy; the
port imports nothing of that package). core/image.py dispatches to these
codecs beyond its own MRC, Spider, TIFF and raw ones. All readers return
(ImageHeader, float32 array); writers exist for the formats the reference
can write. h5py and PIL are imported only when their codecs run.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError


def _header(shape4, sampling=1.0):
    from xmipp3_tpu_torch.core.image import ImageHeader
    h = ImageHeader()
    h.shape = shape4
    h.sampling = sampling
    return h


# ---------------------------------------------------------------------------
# Imagic (.hed header records + .img raw data)
# ---------------------------------------------------------------------------

_IMAGIC_TYPES = {b"REAL": np.float32, b"INTG": np.int16, b"PACK": np.uint8,
                 b"LONG": np.int32}


def _imagic_pair(path):
    root, ext = os.path.splitext(path)
    return root + ".hed", root + ".img"


def read_imagic(path, header_only=False, idx=None):
    """Imagic: .hed = one 1024-byte record per image (int32 fields: [0]
    image number, [1] images following, [12] IXLP rows, [13] IYLP cols,
    [14] 4-char type); .img = consecutive raw records (verified against the
    reference test fixtures singleImage.hed/img, smallStack.hed/img)."""
    hed, img = _imagic_pair(path)
    if not os.path.exists(hed) or not os.path.exists(img):
        raise XmippError(ErrCode.IO_NOTEXIST, f"{hed} / {img}")
    recs = np.fromfile(hed, dtype="<i4")
    if recs.size < 256 or recs.size % 256:
        raise XmippError(ErrCode.IMG_UNKNOWN, "not an Imagic header")
    n = recs.size // 256
    r0 = recs[:256]
    ny, nx = int(r0[12]), int(r0[13])
    tstr = r0[14:15].tobytes()
    dt = _IMAGIC_TYPES.get(tstr)
    if dt is None or nx <= 0 or ny <= 0:
        raise XmippError(ErrCode.IMG_UNKNOWN, f"Imagic type {tstr!r}")
    hdr = _header((n, 1, ny, nx))
    if header_only:
        return hdr, None
    itemsize = np.dtype(dt).itemsize
    if idx is not None:
        off = (int(idx) - 1) * ny * nx * itemsize
        with open(img, "rb") as f:
            f.seek(off)
            data = np.fromfile(f, dtype="<" + np.dtype(dt).char,
                               count=ny * nx).reshape(ny, nx)
    else:
        data = np.fromfile(img, dtype="<" + np.dtype(dt).char,
                           count=n * ny * nx).reshape(n, ny, nx)
        if n == 1:
            data = data[0]
    return hdr, data.astype(np.float32)


def write_imagic(path, data):
    hed, img = _imagic_pair(path)
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[None]
    n, ny, nx = data.shape
    recs = np.zeros((n, 256), dtype="<i4")
    for i in range(n):
        recs[i, 0] = i + 1
        recs[i, 1] = n - 1 - i          # images following
        recs[i, 3] = 1
        recs[i, 12] = ny
        recs[i, 13] = nx
        recs[i, 14] = np.frombuffer(b"REAL", dtype="<i4")[0]
        recs[i, 11] = ny * nx
        recs[i, 10] = ny * nx
    recs.tofile(hed)
    data.astype("<f4").tofile(img)


# ---------------------------------------------------------------------------
# EM (TOM toolbox / EM package: 512-byte header + raw data)
# ---------------------------------------------------------------------------

_EM_TYPES = {1: np.uint8, 2: np.int16, 4: np.int32, 5: np.float32,
             8: np.complex64, 9: np.float64}


def read_em(path, header_only=False):
    """EM: byte 0 machine (6 = little-endian PC), byte 3 data type code,
    bytes 4..16 xdim/ydim/zdim int32, 80B comment, 40 int32 params, 256B
    user data (512-byte header total)."""
    with open(path, "rb") as f:
        raw = f.read(512)
        if len(raw) < 512:
            raise XmippError(ErrCode.IMG_UNKNOWN, "not an EM file")
        machine, _, _, tcode = raw[0], raw[1], raw[2], raw[3]
        endian = "<" if machine in (6, 4) else ">"
        nx, ny, nz = struct.unpack(endian + "3i", raw[4:16])
        dt = _EM_TYPES.get(tcode)
        if dt is None or not (0 < nx < 1 << 20 and 0 < ny < 1 << 20
                              and 0 < nz < 1 << 20):
            raise XmippError(ErrCode.IMG_UNKNOWN, "not an EM file")
        hdr = _header((1, nz, ny, nx) if nz > 1 else (1, 1, ny, nx))
        if header_only:
            return hdr, None
        data = np.fromfile(f, dtype=np.dtype(dt).newbyteorder(endian),
                           count=nx * ny * nz)
    data = data.reshape((nz, ny, nx) if nz > 1 else (ny, nx))
    return hdr, data.astype(np.float32)


def write_em(path, data):
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[None]
    nz, ny, nx = data.shape
    hdr = bytearray(512)
    hdr[0] = 6                           # little-endian PC
    hdr[3] = 5                           # float32
    hdr[4:16] = struct.pack("<3i", nx, ny, nz)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        np.squeeze(data).astype("<f4").tofile(f)


# ---------------------------------------------------------------------------
# SER (FEI TIA series)
# ---------------------------------------------------------------------------

_SER_TYPES = {1: np.uint8, 2: np.uint16, 3: np.uint32, 4: np.int8,
              5: np.int16, 6: np.int32, 7: np.float32, 8: np.float64,
              9: np.complex64, 10: np.complex128}


def read_ser(path, header_only=False):
    """FEI TIA .ser reader (2D image series; ES Vision series format)."""
    with open(path, "rb") as f:
        bo, sid, ver = struct.unpack("<3h", f.read(6))
        if bo != 0x4949 or sid != 0x0197:
            raise XmippError(ErrCode.IMG_UNKNOWN, "not a SER file")
        dtype_id, tag_id, tot, valid = struct.unpack("<4i", f.read(16))
        off_t = "<q" if ver >= 0x0220 else "<i"
        (arr_off,) = struct.unpack(off_t, f.read(struct.calcsize(off_t)))
        (ndim,) = struct.unpack("<i", f.read(4))
        for _ in range(ndim):            # skip dimension arrays
            f.read(4)                    # DimensionSize
            f.read(16)                   # CalibrationOffset/Delta
            f.read(8)                    # CalibrationElement, DescriptionLen
            f.seek(-4, 1)
            (dlen,) = struct.unpack("<i", f.read(4))
            f.read(dlen)
            (ulen,) = struct.unpack("<i", f.read(4))
            f.read(ulen)
        f.seek(arr_off)
        offs = np.fromfile(f, dtype=np.dtype(off_t[1]).newbyteorder("<"),
                           count=tot)[:valid]
        imgs = []
        shape = None
        for o in offs:
            f.seek(int(o))
            f.read(50)                   # 2x(offset f64, delta f64, elem i32)
            f.seek(int(o) + 40)
            (dtc,) = struct.unpack("<h", f.read(2))
            sx, sy = struct.unpack("<2i", f.read(8))
            dt = _SER_TYPES.get(dtc)
            if dt is None:
                raise XmippError(ErrCode.IMG_UNKNOWN, f"SER dtype {dtc}")
            shape = (sy, sx)
            if not header_only:
                imgs.append(np.fromfile(
                    f, dtype=np.dtype(dt).newbyteorder("<"),
                    count=sx * sy).reshape(sy, sx))
    n = len(offs)
    hdr = _header((n, 1) + (shape or (0, 0)))
    if header_only:
        return hdr, None
    data = np.stack(imgs).astype(np.float32)
    return hdr, data[0] if n == 1 else data


def write_ser(path, data):
    """Minimal single/multi-image 2D SER writer (version 0x0210)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[None]
    n, ny, nx = data.shape
    head = struct.pack("<3h", 0x4949, 0x0197, 0x0210)
    head += struct.pack("<4i", 0x4122, 0x4152, n, n)
    fixed = len(head) + 4 + 4 + 4 + 16 + 4 + 4 + 4 + 4  # + arrayoff + ndim + dim record
    # dimension record: size, caloffset, caldelta, calelement, desclen, unitlen
    dim = struct.pack("<i", n) + struct.pack("<2d", 0.0, 1.0) \
        + struct.pack("<i", 0) + struct.pack("<i", 0) + struct.pack("<i", 0)
    arr_off = 6 + 16 + 4 + 4 + len(dim)
    elem_bytes = 50 + nx * ny * 4
    offs = [arr_off + 4 * n + i * elem_bytes for i in range(n)]
    with open(path, "wb") as f:
        f.write(struct.pack("<3h", 0x4949, 0x0197, 0x0210))
        f.write(struct.pack("<4i", 0x4122, 0x4152, n, n))
        f.write(struct.pack("<i", arr_off))
        f.write(struct.pack("<i", 1))
        f.write(dim)
        f.write(np.asarray(offs, "<i4").tobytes())
        for i in range(n):
            f.write(struct.pack("<2d", 0.0, 1.0) + struct.pack("<i", 0))
            f.write(struct.pack("<2d", 0.0, 1.0) + struct.pack("<i", 0))
            f.write(struct.pack("<h", 7))
            f.write(struct.pack("<2i", nx, ny))
            f.write(data[i].astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# DM3 / DM4 (Gatan Digital Micrograph tag trees) — read only
# ---------------------------------------------------------------------------

_DM_SIMPLE = {2: "<i2", 3: "<i4", 4: "<u2", 5: "<u4", 6: "<f4", 7: "<f8",
              8: "<u1", 9: "<i1", 10: "<u1", 11: "<i8", 12: "<u8"}


class _DMReader:
    def __init__(self, f, version):
        self.f = f
        self.v = version
        self.tags = {}

    def _long(self):
        return struct.unpack(">q" if self.v == 4 else ">i",
                             self.f.read(8 if self.v == 4 else 4))[0]

    def parse_dir(self, prefix):
        f = self.f
        f.read(2)                        # sorted, closed
        ntags = self._long()
        for tag_i in range(ntags):
            kind = f.read(1)[0]
            if kind == 0:
                break
            (nlen,) = struct.unpack(">h", f.read(2))
            name = f.read(nlen).decode("latin1") if nlen else f"[{tag_i}]"
            if self.v == 4:
                f.read(8)                # total bytes of this tag
            if kind == 0x14:
                self.parse_dir(prefix + name + ".")
            elif kind == 0x15:
                self.read_data(prefix + name)
            else:
                raise XmippError(ErrCode.IMG_UNKNOWN, f"DM tag kind {kind}")

    def read_data(self, name):
        f = self.f
        if f.read(4) != b"%%%%":
            raise XmippError(ErrCode.IMG_UNKNOWN, "DM tag marker")
        deflen = self._long()
        defn = [self._long() for _ in range(deflen)]
        self.tags[name] = self._read_by_def(defn)

    def _read_by_def(self, defn):
        f = self.f
        t = defn[0]
        if t in _DM_SIMPLE:
            fmt = _DM_SIMPLE[t]
            return np.frombuffer(f.read(np.dtype(fmt).itemsize),
                                 dtype=fmt)[0]
        if t == 18:                      # string
            return f.read(defn[1]).decode("latin1")
        if t == 15:                      # struct
            nfields = defn[2]
            vals = []
            for i in range(nfields):
                ft = defn[4 + 2 * i]
                vals.append(self._read_by_def([ft]))
            return tuple(vals)
        if t == 20:                      # array
            et = defn[1]
            count = defn[-1]
            if et in _DM_SIMPLE:
                fmt = _DM_SIMPLE[et]
                return np.frombuffer(
                    f.read(np.dtype(fmt).itemsize * count), dtype=fmt)
            if et == 15:                 # array of structs
                nfields = defn[3]
                ftypes = [defn[5 + 2 * i] for i in range(nfields)]
                sz = sum(np.dtype(_DM_SIMPLE[ft]).itemsize for ft in ftypes)
                f.read(sz * count)
                return None
            raise XmippError(ErrCode.IMG_UNKNOWN, f"DM array elem {et}")
        raise XmippError(ErrCode.IMG_UNKNOWN, f"DM def type {t}")


def read_dm(path, header_only=False):
    """DM3/DM4 reader: parses the full tag tree, then selects the largest
    ImageList Data array with its Dimensions (thumbnails are smaller)."""
    with open(path, "rb") as f:
        (version,) = struct.unpack(">i", f.read(4))
        if version not in (3, 4):
            raise XmippError(ErrCode.IMG_UNKNOWN, "not a DM3/DM4 file")
        f.read(8 if version == 4 else 4)           # root length
        (byteorder,) = struct.unpack(">i", f.read(4))
        rd = _DMReader(f, version)
        rd.parse_dir("")
    best = None
    for name, val in rd.tags.items():
        if name.endswith(".ImageData.Data") and isinstance(val, np.ndarray):
            if best is None or val.size > rd.tags[best].size:
                best = name
    if best is None:
        raise XmippError(ErrCode.IMG_UNKNOWN, "no image data in DM file")
    arr = rd.tags[best]
    base = best[:-len("Data")]
    dims = []
    i = 0
    while True:
        key = f"{base}Dimensions.[{i}]"
        if key in rd.tags:
            dims.append(int(rd.tags[key]))
            i += 1
        else:
            break
    if not dims:
        dims = [arr.size]
    shape = tuple(reversed(dims))                   # stored x-fastest
    data = arr.reshape(shape).astype(np.float32)
    if data.ndim == 2:
        hdr = _header((1, 1) + data.shape)
    else:
        hdr = _header((data.shape[0], 1) + data.shape[1:])
    return hdr, (None if header_only else data)


# ---------------------------------------------------------------------------
# PIF (Purdue Image Format)
# ---------------------------------------------------------------------------
# Layout per the public PIF description (512-byte file header with magic
# ints (8, 8), an ASCII FLOATSCALE factor, image count and global dims;
# one 512-byte header per image; pixel data stored as scaled integers).
# The format is effectively extinct and no reference fixtures exist, so the
# codec is validated by roundtrip; historic files with deviating layouts
# raise a clear error instead of misreading.

_PIF_MODES = {0: np.int8, 1: np.int16, 2: np.int32, 7: np.float32}


def read_pif(path, header_only=False, idx=None):
    with open(path, "rb") as f:
        hdr = f.read(512)
        if len(hdr) < 512:
            raise XmippError(ErrCode.IMG_UNKNOWN, "not a PIF file")
        m0, m1 = struct.unpack("<2i", hdr[0:8])
        if (m0, m1) != (8, 8):
            raise XmippError(ErrCode.IMG_UNKNOWN, "not a PIF file (magic)")
        try:
            scale = float(hdr[8:24].split(b"\x00")[0] or b"1")
        except ValueError:
            scale = 1.0
        n_imgs, _endian = struct.unpack("<2i", hdr[24:32])
        htype, nx, ny, nz, mode = struct.unpack("<5i", hdr[64:84])
        dt = _PIF_MODES.get(mode)
        if dt is None or nx <= 0 or ny <= 0:
            raise XmippError(ErrCode.IMG_UNKNOWN, f"PIF mode {mode}")
        shape4 = (n_imgs, max(nz, 1), ny, nx)
        h = _header(shape4)
        if header_only:
            return h, None
        item = np.dtype(dt).itemsize
        frame_bytes = 512 + nx * ny * max(nz, 1) * item
        sel = range(n_imgs) if idx is None else [int(idx) - 1]
        frames = []
        for i in sel:
            f.seek(512 + i * frame_bytes + 512)       # skip image header
            a = np.fromfile(f, dtype="<" + np.dtype(dt).char,
                            count=nx * ny * max(nz, 1))
            frames.append(a.reshape((max(nz, 1), ny, nx)))
        data = np.squeeze(np.stack(frames)).astype(np.float32)
        if np.issubdtype(dt, np.integer) and scale not in (0.0, 1.0):
            data = data * np.float32(scale)
    return h, data


def write_pif(path, data, scale=None):
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[None]
    if data.ndim == 3:                       # stack of 2D images
        data = data[:, None]                 # (n, 1, ny, nx)
    n, nz, ny, nx = data.shape
    peak = float(np.abs(data).max()) or 1.0
    scale = scale or peak / 32000.0
    hdr = bytearray(512)
    hdr[0:8] = struct.pack("<2i", 8, 8)
    hdr[8:24] = f"{scale:.8g}".encode().ljust(16, b"\x00")
    hdr[24:32] = struct.pack("<2i", n, 0)
    hdr[64:84] = struct.pack("<5i", 1, nx, ny, nz, 1)  # htype, dims, mode i16
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        ih = bytearray(512)
        ih[0:16] = struct.pack("<4i", nx, ny, nz, 1)
        for i in range(n):
            f.write(bytes(ih))
            f.write(np.round(data[i] / scale).astype("<i2").tobytes())


# ---------------------------------------------------------------------------
# HDF5
# ---------------------------------------------------------------------------

def _h5_first_dataset(g):
    import h5py
    found = []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset) and obj.ndim >= 2:
            found.append(name)

    g.visititems(visit)
    return found[0] if found else None


def read_hdf5(path, header_only=False, dataset=None):
    import h5py
    with h5py.File(path, "r") as f:
        ds = dataset or _h5_first_dataset(f)
        if ds is None:
            raise XmippError(ErrCode.IMG_UNKNOWN, "no 2D+ dataset in HDF5")
        d = f[ds]
        shape = d.shape
        if len(shape) == 2:
            hdr = _header((1, 1) + tuple(shape))
        else:
            hdr = _header((shape[0], 1) + tuple(shape[-2:]))
        if header_only:
            return hdr, None
        return hdr, np.asarray(d[...], np.float32)


def write_hdf5(path, data, dataset="data"):
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset(dataset, data=np.asarray(data, np.float32))


# ---------------------------------------------------------------------------
# JPEG / PNG (via PIL)
# ---------------------------------------------------------------------------

def read_pil(path, header_only=False):
    from PIL import Image as PILImage
    im = PILImage.open(path)
    hdr = _header((1, 1, im.height, im.width))
    if header_only:
        return hdr, None
    return hdr, np.asarray(im.convert("F"), np.float32)


def write_pil(path, data):
    from PIL import Image as PILImage
    d = np.squeeze(np.asarray(data, np.float32))
    if d.ndim != 2:
        raise XmippError(ErrCode.IMG_NOWRITE, "JPEG/PNG needs a 2D image")
    lo, hi = float(d.min()), float(d.max())
    u8 = np.zeros_like(d, np.uint8) if hi <= lo else \
        np.clip((d - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)
    PILImage.fromarray(u8, mode="L").save(path)
