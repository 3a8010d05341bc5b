"""Image I/O: MRC/MRCS, Spider (.spi/.stk/.vol/.xmp), RAW+INF and TIFF
codecs, and the dispatch to the other formats' codecs (Imagic, EM, SER,
DM3/DM4, PIF, HDF5, JPEG/PNG) in core/image_formats.py.

Equivalent of xmippCore's Image<T> (SURVEY.md §1.1: header-only reads, stack
slice addressing "n@stack", format zoo enumerated in the reference's
data/xmipp_image_convert.cpp:86-95). Data model: numpy array, float32 default,
shape (Y,X), (Z,Y,X) or (N,Y,X)/(N,Z,Y,X) for stacks; device transfer happens
in ops (arrays go to the device in batches, never element-wise).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.filename import FileName, as_filename

# ---------------------------------------------------------------------------
# MRC / MRCS
# ---------------------------------------------------------------------------

_MRC_MODE_TO_DTYPE = {
    0: np.int8, 1: np.int16, 2: np.float32, 3: np.complex64,
    4: np.complex64, 6: np.uint16, 12: np.float16,
}
_DTYPE_TO_MRC_MODE = {
    np.dtype(np.int8): 0, np.dtype(np.int16): 1, np.dtype(np.float32): 2,
    np.dtype(np.uint16): 6, np.dtype(np.float16): 12, np.dtype(np.uint8): 0,
}


@dataclass
class ImageHeader:
    shape: tuple = ()          # (N, Z, Y, X)
    dtype: np.dtype = np.dtype(np.float32)
    sampling: float = 1.0      # Å/px
    n_images: int = 1
    format: str = ""


def _read_mrc_header(f) -> tuple[ImageHeader, int, bool, bool]:
    raw = f.read(1024)
    if len(raw) < 1024:
        raise XmippError(ErrCode.IO_SIZE, "truncated MRC header")
    # machine stamp / sanity decides byte order
    def words(order):
        return np.frombuffer(raw, dtype=np.dtype(np.int32).newbyteorder(order), count=56)
    order = "<"
    h = words(order)
    if not (0 <= h[3] <= 101 and h[0] > 0 and h[0] < 1 << 20):
        order = ">"
        h = words(order)
    nx, ny, nz, mode = int(h[0]), int(h[1]), int(h[2]), int(h[3])
    mz = int(h[9]) if int(h[9]) > 0 else 1
    fwords = np.frombuffer(raw, dtype=np.dtype(np.float32).newbyteorder(order), count=56)
    xlen = float(fwords[10])
    sampling = xlen / nx if nx and xlen > 0 else 1.0
    nsymbt = int(h[23])
    if mode not in _MRC_MODE_TO_DTYPE:
        raise XmippError(ErrCode.IMG_UNKNOWN, f"MRC mode {mode}")
    dtype = np.dtype(_MRC_MODE_TO_DTYPE[mode]).newbyteorder(order)
    ispg = int(h[22])
    # volume vs stack: xmipp convention — .mrcs / ispg==0 & nz>1 → stack of 2D
    is_stack = (ispg == 0 and mz == 1 and nz > 1)
    hdr = ImageHeader(dtype=np.dtype(_MRC_MODE_TO_DTYPE[mode]), sampling=sampling,
                      format="mrc")
    if is_stack:
        hdr.shape = (nz, 1, ny, nx)
        hdr.n_images = nz
    else:
        hdr.shape = (1, nz, ny, nx)
        hdr.n_images = 1
    return hdr, 1024 + nsymbt, order == ">", is_stack


def read_mrc(path: str, header_only=False, slice_index: int | None = None,
             as_stack: bool | None = None):
    with open(path, "rb") as f:
        hdr, offset, swapped, is_stack = _read_mrc_header(f)
        if as_stack is not None:
            is_stack = as_stack or hdr.n_images > 1
        if header_only:
            return hdr, None
        n, z, y, x = hdr.shape
        dt = hdr.dtype.newbyteorder(">") if swapped else hdr.dtype
        item = dt.itemsize
        if slice_index is not None:
            if not 1 <= slice_index <= max(n, z):
                raise XmippError(ErrCode.INDEX_OUTOFBOUNDS,
                                 f"slice {slice_index} of {path}")
            f.seek(offset + (slice_index - 1) * y * x * item)
            data = np.fromfile(f, dtype=dt, count=y * x).reshape(y, x)
        else:
            f.seek(offset)
            data = np.fromfile(f, dtype=dt, count=n * z * y * x)
            data = data.reshape((n, y, x) if is_stack and n > 1 else
                                (z, y, x) if z > 1 else (y, x))
        return hdr, data.astype(np.float32) if data.dtype != np.float32 else data


def write_mrc(path: str, data: np.ndarray, sampling: float = 1.0,
              is_stack: bool | None = None, dtype=np.float32) -> None:
    data = np.asarray(data)
    if is_stack is None:
        is_stack = path.endswith(".mrcs") or path.endswith(".st")
    if data.ndim == 2:
        data = data[None]
        nz = 1 if not is_stack else 1
    data = np.ascontiguousarray(data.astype(dtype))
    nz, ny, nx = data.shape
    mode = _DTYPE_TO_MRC_MODE[np.dtype(dtype)]
    hdr_i = np.zeros(256, dtype=np.int32)
    hdr_f = hdr_i.view(np.float32)
    hdr_i[0:3] = (nx, ny, nz)
    hdr_i[3] = mode
    mz = 1 if is_stack else nz
    hdr_i[7:10] = (nx, ny, mz)
    hdr_f[10:13] = (nx * sampling, ny * sampling, mz * sampling)
    hdr_f[13:16] = (90.0, 90.0, 90.0)
    hdr_i[16:19] = (1, 2, 3)
    hdr_f[19] = float(data.min())
    hdr_f[20] = float(data.max())
    hdr_f[21] = float(data.mean())
    hdr_i[22] = 0 if is_stack else 1              # ispg
    hdr_i[52] = struct.unpack("<i", b"MAP ")[0]   # map id
    hdr_i[53] = struct.unpack("<i", bytes([0x44, 0x44, 0, 0]))[0]  # machst LE
    hdr_f[54] = float(data.std())
    with open(path, "wb") as f:
        f.write(hdr_i.tobytes())
        data.tofile(f)           # zero-copy stream (tobytes would duplicate)


# ---------------------------------------------------------------------------
# Spider (.spi / .stk / .vol / .xmp)
# ---------------------------------------------------------------------------

def _spider_header_geom(nsam: int) -> tuple[int, int]:
    lenbyt = nsam * 4
    labrec = (1024 + lenbyt - 1) // lenbyt
    return labrec, labrec * lenbyt


def _parse_spider_header(raw: bytes):
    for order in ("<", ">"):
        h = np.frombuffer(raw, dtype=np.dtype(np.float32).newbyteorder(order),
                          count=min(len(raw) // 4, 256))
        if len(h) < 24:
            continue
        nsam, labrec, labbyt, lenbyt = h[11], h[12], h[21], h[22]
        if (nsam > 0 and lenbyt == nsam * 4 and labbyt == labrec * lenbyt
                and nsam < 1 << 20):
            return h.astype(np.float32), order
    raise XmippError(ErrCode.IMG_UNKNOWN, "not a Spider file")


def read_spider(path: str, header_only=False, slice_index: int | None = None):
    with open(path, "rb") as f:
        raw = f.read(1024)
        h, order = _parse_spider_header(raw)
        nslice, nrow, nsam = int(h[0]), int(h[1]), int(h[11])
        labbyt = int(h[21])
        istack, maxim = int(h[23]), int(h[25])
        dt = np.dtype(np.float32).newbyteorder(order)
        hdr = ImageHeader(sampling=1.0, format="spider")
        img_bytes = nslice * nrow * nsam * 4
        if istack > 0:  # stack: overall header + per-image (header+data)
            n = maxim
            hdr.shape = (n, nslice, nrow, nsam)
            hdr.n_images = n
            if header_only:
                return hdr, None
            per = labbyt + img_bytes
            if slice_index is not None:
                f.seek(labbyt + (slice_index - 1) * per + labbyt)
                data = np.fromfile(f, dtype=dt, count=nslice * nrow * nsam)
                data = data.reshape(nrow, nsam) if nslice == 1 else \
                    data.reshape(nslice, nrow, nsam)
            else:
                out = np.empty((n, nslice, nrow, nsam), dtype=np.float32)
                for i in range(n):
                    f.seek(labbyt + i * per + labbyt)
                    chunk = np.fromfile(f, dtype=dt, count=nslice * nrow * nsam)
                    if chunk.size != nslice * nrow * nsam:
                        raise XmippError(
                            ErrCode.IO_SIZE,
                            f"truncated stack {path}: image {i + 1}/{n}")
                    out[i] = chunk.reshape(nslice, nrow, nsam)
                data = out[:, 0] if nslice == 1 else out
        else:
            hdr.shape = (1, nslice, nrow, nsam)
            if header_only:
                return hdr, None
            f.seek(labbyt)
            data = np.fromfile(f, dtype=dt, count=nslice * nrow * nsam)
            data = data.reshape(nrow, nsam) if nslice == 1 else \
                data.reshape(nslice, nrow, nsam)
        return hdr, np.ascontiguousarray(data, dtype=np.float32)


def _spider_header(nsam, nrow, nslice, istack=0, maxim=0, imgnum=0) -> np.ndarray:
    labrec, labbyt = _spider_header_geom(nsam)
    h = np.zeros(labbyt // 4, dtype=np.float32)
    h[0] = nslice
    h[1] = nrow
    h[2] = nrow * nslice              # irec
    h[4] = 3.0 if nslice > 1 else 1.0  # iform
    h[11] = nsam
    h[12] = labrec
    h[21] = labbyt
    h[22] = nsam * 4
    h[23] = istack
    h[25] = maxim
    h[26] = imgnum
    return h


def write_spider(path: str, data: np.ndarray) -> None:
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
    is_stack = path.endswith(".stk")
    with open(path, "wb") as f:
        if is_stack:
            if data.ndim == 2:
                data = data[None]
            if data.ndim == 3:
                n, nrow, nsam = data.shape
                nslice = 1
            else:
                n, nslice, nrow, nsam = data.shape
            f.write(_spider_header(nsam, nrow, nslice, istack=2, maxim=n).tobytes())
            for i in range(n):
                f.write(_spider_header(nsam, nrow, nslice, imgnum=i + 1).tobytes())
                f.write(data[i].tobytes())
        else:
            if data.ndim == 2:
                nslice, (nrow, nsam) = 1, data.shape
            else:
                nslice, nrow, nsam = data.shape
            f.write(_spider_header(nsam, nrow, nslice).tobytes())
            f.write(data.tobytes())


# Per-image geometry words of the SPIDER header (1-based words 15-21 of the
# standard: IANGLE, PHI, THETA, GAMMA, XOFF, YOFF, ZOFF; PIXSIZ at word 38).
# The reference's image_header --extract/--assign/--reset operate on these
# (reconstruction/image_header.cpp:52-67).
_SPI_IANGLE, _SPI_PHI, _SPI_XOFF, _SPI_PIXSIZ = 14, 15, 18, 37


def _spider_image_headers(path):
    """Yield (byte_offset, header_array) for each image header in a Spider
    file (overall header for single images/volumes; the per-image headers
    for .stk stacks)."""
    with open(path, "rb") as f:
        raw = f.read(1024)
        h, order = _parse_spider_header(raw)
        nslice, nrow, nsam = int(h[0]), int(h[1]), int(h[11])
        labbyt, istack, maxim = int(h[21]), int(h[23]), int(h[25])
        dt = np.dtype(np.float32).newbyteorder(order)
        img_bytes = nslice * nrow * nsam * 4
        if istack > 0:
            per = labbyt + img_bytes
            for i in range(maxim):
                off = labbyt + i * per
                f.seek(off)
                hi = np.frombuffer(f.read(labbyt), dtype=dt).copy()
                yield off, hi
        else:
            yield 0, np.frombuffer(raw[:labbyt].ljust(labbyt, b"\0"),
                                   dtype=dt).copy()


def read_spider_geo(path) -> list[dict]:
    """Per-image Euler angles + offsets from Spider headers (words 16-21)."""
    rows = []
    for _off, h in _spider_image_headers(path):
        rows.append(dict(angleRot=float(h[_SPI_PHI]),
                         angleTilt=float(h[_SPI_PHI + 1]),
                         anglePsi=float(h[_SPI_PHI + 2]),
                         shiftX=float(h[_SPI_XOFF]),
                         shiftY=float(h[_SPI_XOFF + 1]),
                         shiftZ=float(h[_SPI_XOFF + 2])))
    return rows


def write_spider_geo(path, rows: list[dict] | None = None,
                     reset: bool = False, round_shifts: bool = False) -> None:
    """Patch per-image geometry words of Spider headers in place.

    rows carry angleRot/angleTilt/anglePsi/shiftX/shiftY/shiftZ; reset zeroes
    the geometry and clears the IANGLE flag (image_header --assign/--reset).
    rows may also be a dict mapping 0-based in-stack slot index -> row, so a
    sorted/filtered metadata patches the slot named by each row's NNNNNN@
    prefix rather than trusting row order."""
    if isinstance(rows, dict):
        by_slot = rows
    elif rows is not None:
        by_slot = dict(enumerate(rows))
    else:
        by_slot = None
    patches = []
    for i, (off, h) in enumerate(_spider_image_headers(path)):
        if reset:
            h[_SPI_IANGLE] = 0.0
            h[_SPI_PHI:_SPI_PHI + 3] = 0.0
            h[_SPI_XOFF:_SPI_XOFF + 3] = 0.0
        elif by_slot is not None and i in by_slot:
            r = by_slot[i]
            h[_SPI_IANGLE] = 1.0
            h[_SPI_PHI] = float(r.get("angleRot", 0.0) or 0.0)
            h[_SPI_PHI + 1] = float(r.get("angleTilt", 0.0) or 0.0)
            h[_SPI_PHI + 2] = float(r.get("anglePsi", 0.0) or 0.0)
            sx = float(r.get("shiftX", 0.0) or 0.0)
            sy = float(r.get("shiftY", 0.0) or 0.0)
            sz = float(r.get("shiftZ", 0.0) or 0.0)
            if round_shifts:
                sx, sy, sz = round(sx), round(sy), round(sz)
            h[_SPI_XOFF:_SPI_XOFF + 3] = (sx, sy, sz)
        patches.append((off, h))
    with open(path, "r+b") as f:
        for off, h in patches:
            f.seek(off)
            f.write(h.tobytes())


def set_image_sampling(path: str, sampling: float) -> None:
    """Patch the sampling rate stored in an image file header in place
    (MRC: cella words 11-13 = dims*Ts; Spider: PIXSIZ word 38)."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in ("mrc", "mrcs", "st", "ali", "rec"):
        with open(path, "r+b") as f:
            hdr = np.frombuffer(f.read(1024), dtype="<i4").copy()
            hf = hdr.view(np.float32)
            hf[10:13] = (hdr[7] * sampling, hdr[8] * sampling,
                         hdr[9] * sampling)
            f.seek(0)
            f.write(hdr.tobytes())
    else:
        patches = [(off, h) for off, h in _spider_image_headers(path)]
        with open(path, "r+b") as f:
            for off, h in patches:
                h[_SPI_PIXSIZ] = sampling
                f.seek(off)
                f.write(h.tobytes())


def get_image_sampling(path: str) -> float:
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in ("mrc", "mrcs", "st", "ali", "rec"):
        with open(path, "rb") as f:
            hdr = np.frombuffer(f.read(1024), dtype="<i4")
            hf = hdr.view(np.float32)
            return float(hf[10] / hdr[7]) if hdr[7] else 1.0
    for _off, h in _spider_image_headers(path):
        return float(h[_SPI_PIXSIZ]) or 1.0
    return 1.0


# ---------------------------------------------------------------------------
# RAW + INF
# ---------------------------------------------------------------------------

def _read_inf(path: str) -> dict:
    kv = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip().lower()] = v.strip()
    return kv


def read_raw(path: str, header_only=False):
    inf_path = path + ".inf" if os.path.exists(path + ".inf") else \
        os.path.splitext(path)[0] + ".inf"
    if not os.path.exists(inf_path):
        raise XmippError(ErrCode.IO_NOTEXIST, inf_path)
    kv = _read_inf(inf_path)
    bits = int(kv.get("bitspersample", 32))
    signed = kv.get("is_signed", "true").lower() in ("true", "1", "yes")
    xdim, ydim = int(kv["xdim"]), int(kv["ydim"])
    offset = int(kv.get("offset", 0))
    endian = "<" if kv.get("endianess", "little").startswith("l") else ">"
    if bits == 32:
        dt = np.dtype(np.float32)
    elif bits == 16:
        dt = np.dtype(np.int16 if signed else np.uint16)
    elif bits == 8:
        dt = np.dtype(np.int8 if signed else np.uint8)
    else:
        raise XmippError(ErrCode.IMG_UNKNOWN, f"raw bits {bits}")
    dt = dt.newbyteorder(endian)
    hdr = ImageHeader(shape=(1, 1, ydim, xdim), dtype=np.dtype(dt.str[1:]),
                      format="raw")
    if header_only:
        return hdr, None
    with open(path, "rb") as f:
        f.seek(offset)
        data = np.fromfile(f, dtype=dt, count=xdim * ydim).reshape(ydim, xdim)
    return hdr, data.astype(np.float32)


# ---------------------------------------------------------------------------
# TIFF reader: baseline + PackBits / LZW / Deflate strips (the compression
# schemes libtiff emits for cryo-EM micrographs; reference uses libtiff)
# ---------------------------------------------------------------------------

def _packbits_decode(data: bytes) -> bytes:
    """TIFF PackBits (compression 32773) RLE."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
        # 128 = no-op
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW (compression 5): MSB-first variable-width codes with
    early-change, clear=256, EOI=257."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    prev = None
    bitbuf = 0
    bitcnt = 0
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bitcnt += 8
        while bitcnt >= width:
            code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
            bitcnt -= width
            if code == CLEAR:
                table = table[:258]
                width = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
    return bytes(out)


def _tiff_decompress(data: bytes, compression: int) -> bytes:
    if compression == 1:
        return data
    if compression == 32773:
        return _packbits_decode(data)
    if compression == 5:
        return _lzw_decode(data)
    if compression in (8, 32946):
        import zlib
        return zlib.decompress(data)
    raise XmippError(ErrCode.IMG_UNKNOWN,
                     f"TIFF compression {compression} unsupported")


def read_tiff(path: str, header_only=False):
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:2] == b"II":
            order = "<"
        elif head[:2] == b"MM":
            order = ">"
        else:
            raise XmippError(ErrCode.IMG_UNKNOWN, "not a TIFF")
        ifd_off = struct.unpack(order + "I", head[4:8])[0]
        f.seek(ifd_off)
        ntags = struct.unpack(order + "H", f.read(2))[0]
        tags = {}
        for _ in range(ntags):
            tag, typ, cnt = struct.unpack(order + "HHI", f.read(8))
            val_raw = f.read(4)
            size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 11: 4, 12: 8}.get(typ, 4)
            if size * cnt <= 4:
                if typ == 3:
                    val = struct.unpack(order + "H", val_raw[:2])[0]
                else:
                    val = struct.unpack(order + "I", val_raw)[0]
                tags[tag] = val
            else:
                off = struct.unpack(order + "I", val_raw)[0]
                tags[tag] = (off, typ, cnt)
        width, height = tags[256], tags[257]
        bits = tags.get(258, 8)
        if isinstance(bits, tuple):
            bits = 8  # multi-channel unsupported; treat as gray8
        sfmt = tags.get(339, 1)
        compression = tags.get(259, 1)
        predictor = tags.get(317, 1)
        strip_off = tags[273]
        if isinstance(strip_off, tuple):
            off, typ, cnt = strip_off
            f.seek(off)
            fmtc = "H" if typ == 3 else "I"
            offs = struct.unpack(order + fmtc * cnt,
                                 f.read((2 if typ == 3 else 4) * cnt))
        else:
            offs = (strip_off,)
        strip_cnt = tags.get(279)
        if isinstance(strip_cnt, tuple):
            off, typ, cnt = strip_cnt
            f.seek(off)
            fmtc = "H" if typ == 3 else "I"
            counts = struct.unpack(order + fmtc * cnt,
                                   f.read((2 if typ == 3 else 4) * cnt))
        elif strip_cnt is not None:
            counts = (strip_cnt,)
        else:
            counts = None
        rows_per_strip = tags.get(278, height)
        if isinstance(rows_per_strip, tuple):
            rows_per_strip = height
        if bits == 8:
            dt = np.dtype(np.uint8)
        elif bits == 16:
            dt = np.dtype(np.uint16 if sfmt == 1 else np.int16)
        elif bits == 32:
            dt = np.dtype(np.float32 if sfmt == 3 else np.uint32)
        else:
            raise XmippError(ErrCode.IMG_UNKNOWN, f"TIFF bits {bits}")
        dt = dt.newbyteorder(order)
        hdr = ImageHeader(shape=(1, 1, height, width),
                          dtype=np.dtype(dt.str[1:]), format="tiff")
        if header_only:
            return hdr, None
        rows = []
        remaining = height
        for si, off in enumerate(offs):
            f.seek(off)
            nrows = min(rows_per_strip, remaining)
            if compression == 1:
                strip = np.fromfile(f, dtype=dt, count=nrows * width)
            else:
                raw = f.read(counts[si] if counts else None)
                dec = _tiff_decompress(raw, compression)
                strip = np.frombuffer(dec, dtype=dt,
                                      count=nrows * width).copy()
            strip = strip.reshape(nrows, width)
            if predictor == 2:
                strip = np.cumsum(strip.astype(np.int64), axis=1).astype(
                    dt.base if hasattr(dt, "base") else dt)
            rows.append(strip)
            remaining -= nrows
        return hdr, np.concatenate(rows, axis=0).astype(np.float32)


def write_tiff(path: str, data: np.ndarray) -> None:
    """Baseline little-endian float32 TIFF, one uncompressed strip per page
    (reference: libtiff via rwTIFF writeTIFF)."""
    data = np.atleast_2d(np.asarray(data, dtype="<f4"))
    pages = data.reshape((-1,) + data.shape[-2:])
    with open(path, "wb") as f:
        f.write(b"II*\x00")
        ifd_ptr_pos = f.tell()
        f.write(struct.pack("<I", 0))            # patched per page
        for pi, page in enumerate(pages):
            h, w = page.shape
            strip_off = f.tell()
            f.write(page.tobytes())
            ifd_off = f.tell()
            cur = f.tell()
            f.seek(ifd_ptr_pos)
            f.write(struct.pack("<I", ifd_off))
            f.seek(cur)
            tags = [
                (256, 4, 1, w),                  # ImageWidth
                (257, 4, 1, h),                  # ImageLength
                (258, 3, 1, 32),                 # BitsPerSample
                (259, 3, 1, 1),                  # Compression: none
                (262, 3, 1, 1),                  # Photometric: BlackIsZero
                (273, 4, 1, strip_off),          # StripOffsets
                (277, 3, 1, 1),                  # SamplesPerPixel
                (278, 4, 1, h),                  # RowsPerStrip
                (279, 4, 1, h * w * 4),          # StripByteCounts
                (339, 3, 1, 3),                  # SampleFormat: IEEE float
            ]
            f.write(struct.pack("<H", len(tags)))
            for tag, typ, cnt, val in tags:
                f.write(struct.pack("<HHI", tag, typ, cnt))
                f.write(struct.pack("<H2x", val) if typ == 3
                        else struct.pack("<I", val))
            ifd_ptr_pos = f.tell()
            f.write(struct.pack("<I", 0))        # next-IFD (patched)


def write_raw(path: str, data: np.ndarray) -> None:
    """Headerless float32 raw + the reference's .inf sidecar
    (rwINF writeINF; fixture: resources/test/image/singleImage.raw.inf)."""
    data = np.asarray(data, dtype="<f4")
    if data.ndim != 2:
        data = np.squeeze(data)
    if data.ndim != 2:
        raise XmippError(ErrCode.IMG_NOWRITE, "raw writer is 2-D only")
    with open(path, "wb") as f:
        f.write(data.tobytes())
    ydim, xdim = data.shape
    with open(path + ".inf", "w") as f:
        f.write("# Bits per sample\nbitspersample= 32\n"
                "# Samples per pixel\nsamplesperpixel= 1\n"
                f"# Image width\nXdim= {xdim}\n"
                f"# Image length\nYdim= {ydim}\n"
                "# offset in bytes (zero by default)\noffset= 0\n"
                "# Is a signed or Unsigned int (by default true)\n"
                "is_signed= true\n"
                "# Byte order\nendianess= little\n")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_SPIDER_EXTS = {"spi", "stk", "vol", "xmp", "psd", "psdstk", "fsc"}
_MRC_EXTS = {"mrc", "mrcs", "map", "st", "rec", "ali"}


_EXTRA_EXTS = {"img": "imagic", "hed": "imagic", "em": "em", "ems": "em",
               "ser": "ser", "dm3": "dm", "dm4": "dm", "h5": "hdf5",
               "hdf5": "hdf5", "hdf": "hdf5", "jpg": "pil", "jpeg": "pil",
               "png": "pil", "pif": "pif"}


def _codec_for(fn: FileName) -> str:
    fmt = fn.forced_format or fn.ext
    if fmt in _MRC_EXTS:
        return "mrc"
    if fmt in _SPIDER_EXTS:
        return "spider"
    if fmt in ("raw", "inf"):
        return "raw"
    if fmt in ("tif", "tiff"):
        return "tiff"
    if fmt in _EXTRA_EXTS:
        return _EXTRA_EXTS[fmt]
    # sniff
    path = fn.path
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:2] in (b"II", b"MM"):
            return "tiff"
        if magic in (b"\x00\x00\x00\x03", b"\x00\x00\x00\x04"):
            return "dm"
    except OSError:
        pass
    return "spider_or_mrc"


def _read_stack_runs(path: str, idx: list[int], codec: str):
    """Slices `idx` (0-based) of an MRC or Spider stack of 2-D images with
    one open and one read per run of consecutive indices; None where the
    file is not such a stack (the caller then reads slice by slice)."""
    with open(path, "rb") as f:
        if codec == "mrc":
            hdr, offset, swapped, _ = _read_mrc_header(f)
            n, z, y, x = hdr.shape
            dt = hdr.dtype.newbyteorder(">") if swapped else hdr.dtype
            count, head, skip = max(n, z), offset, 0
            if min(n, z) != 1:
                return None
        else:
            h, order = _parse_spider_header(f.read(1024))
            nslice, y, x = int(h[0]), int(h[1]), int(h[11])
            labbyt, istack, count = int(h[21]), int(h[23]), int(h[25])
            dt = np.dtype(np.float32).newbyteorder(order)
            if istack <= 0 or nslice != 1:
                return None
            head, skip = labbyt, labbyt // 4   # each image follows a header
        if min(idx) < 0 or max(idx) >= count:
            raise XmippError(ErrCode.INDEX_OUTOFBOUNDS,
                             f"slice {max(idx) + 1} of {path}")
        rec = skip + y * x                      # items per stored image
        out = np.empty((len(idx), y, x), np.float32)
        i = 0
        while i < len(idx):
            j = i + 1
            while j < len(idx) and idx[j] == idx[j - 1] + 1:
                j += 1
            f.seek(head + idx[i] * rec * dt.itemsize)
            block = np.fromfile(f, dtype=dt, count=(j - i) * rec)
            if block.size != (j - i) * rec:
                raise XmippError(ErrCode.IO_SIZE, f"truncated stack {path}")
            out[i:j] = block.reshape(j - i, rec)[:, skip:].reshape(-1, y, x)
            i = j
    return out


class Image:
    """In-memory image/volume/stack with format codecs.

    Mirrors the read/write surface of xmippCore Image<T> used throughout the
    reference (header-only reads, "n@stack" slices), with numpy storage.
    """

    def __init__(self, source=None):
        self.data: np.ndarray | None = None
        self.header = ImageHeader()
        self.filename: str = ""
        if source is not None:
            if isinstance(source, np.ndarray):
                self.data = np.asarray(source, dtype=np.float32)
                self.header.shape = ((1,) * (4 - self.data.ndim)) + self.data.shape
            else:
                self.read(source)

    # -- reading --------------------------------------------------------
    def read(self, fn, header_only: bool = False) -> "Image":
        fn = as_filename(fn)
        self.filename = str(fn)
        codec = _codec_for(fn)
        path, idx = fn.path, fn.slice_index
        if not os.path.exists(path):
            raise XmippError(ErrCode.IO_NOTEXIST, path)
        if codec == "mrc":
            self.header, self.data = read_mrc(path, header_only, idx)
        elif codec == "spider":
            self.header, self.data = read_spider(path, header_only, idx)
        elif codec == "raw":
            self.header, self.data = read_raw(path, header_only)
        elif codec == "tiff":
            self.header, self.data = read_tiff(path, header_only)
        elif codec == "imagic":
            from xmipp3_tpu_torch.core.image_formats import read_imagic
            self.header, self.data = read_imagic(path, header_only, idx)
        elif codec == "em":
            from xmipp3_tpu_torch.core.image_formats import read_em
            self.header, self.data = read_em(path, header_only)
        elif codec == "ser":
            from xmipp3_tpu_torch.core.image_formats import read_ser
            self.header, self.data = read_ser(path, header_only)
        elif codec == "dm":
            from xmipp3_tpu_torch.core.image_formats import read_dm
            self.header, self.data = read_dm(path, header_only)
        elif codec == "hdf5":
            from xmipp3_tpu_torch.core.image_formats import read_hdf5
            self.header, self.data = read_hdf5(path, header_only)
        elif codec == "pil":
            from xmipp3_tpu_torch.core.image_formats import read_pil
            self.header, self.data = read_pil(path, header_only)
        elif codec == "pif":
            from xmipp3_tpu_torch.core.image_formats import read_pif
            self.header, self.data = read_pif(path, header_only, idx)
        else:
            try:
                self.header, self.data = read_spider(path, header_only, idx)
            except XmippError:
                self.header, self.data = read_mrc(path, header_only, idx)
        return self

    @staticmethod
    def read_stack(fn) -> np.ndarray:
        """Whole stack as (N, Y, X) float32."""
        img = Image()
        img.read(as_filename(fn))
        d = img.data
        if d.ndim == 2:
            d = d[None]
        return d

    @staticmethod
    def read_slices(path: str, indices) -> np.ndarray:
        """Read selected 0-based slices of a stack as (n, Y, X) float32.

        An MRC or Spider stack of 2-D images is opened once, and every run
        of consecutive indices is fetched with one read; other files are
        read slice by slice."""
        fn_obj = as_filename(path)
        idx = [int(i) for i in np.asarray(indices).ravel()]
        codec = _codec_for(fn_obj)
        out = None
        if idx and codec in ("mrc", "spider") and os.path.exists(fn_obj.path):
            out = _read_stack_runs(fn_obj.path, idx, codec)
        if out is not None:
            return out
        return np.stack([
            np.squeeze(Image(f"{i + 1}@{fn_obj.path}").data)
            for i in idx]).astype(np.float32)

    # -- writing --------------------------------------------------------
    def write(self, fn, sampling: float | None = None) -> None:
        fn = as_filename(fn)
        fmt = fn.forced_format or fn.ext
        s = sampling or self.header.sampling or 1.0
        if fmt in _MRC_EXTS:
            write_mrc(fn.path, self.data, sampling=s,
                      is_stack=(fmt in ("mrcs", "st") or
                                (self.data.ndim == 3 and fmt not in
                                 ("mrc", "map", "vol", "rec"))))
        elif fmt in _SPIDER_EXTS:
            write_spider(fn.path, self.data)
        elif fmt in ("img", "hed"):
            from xmipp3_tpu_torch.core.image_formats import write_imagic
            write_imagic(fn.path, self.data)
        elif fmt in ("em", "ems"):
            from xmipp3_tpu_torch.core.image_formats import write_em
            write_em(fn.path, self.data)
        elif fmt == "ser":
            from xmipp3_tpu_torch.core.image_formats import write_ser
            write_ser(fn.path, self.data)
        elif fmt in ("h5", "hdf5", "hdf"):
            from xmipp3_tpu_torch.core.image_formats import write_hdf5
            write_hdf5(fn.path, self.data)
        elif fmt in ("jpg", "jpeg", "png"):
            from xmipp3_tpu_torch.core.image_formats import write_pil
            write_pil(fn.path, self.data)
        elif fmt == "pif":
            from xmipp3_tpu_torch.core.image_formats import write_pif
            write_pif(fn.path, self.data)
        elif fmt in ("tif", "tiff"):
            write_tiff(fn.path, self.data)
        elif fmt in ("raw", "inf"):
            write_raw(fn.path, self.data)
        else:
            raise XmippError(ErrCode.IMG_NOWRITE, f"format {fmt}")

    # -- helpers --------------------------------------------------------
    def getDimensions(self) -> tuple[int, int, int, int]:
        n, z, y, x = self.header.shape if self.header.shape else (1, 1) + self.data.shape
        return (x, y, z, n)

    def equal(self, other: "Image", tol: float = 1e-3) -> bool:
        a, b = np.squeeze(self.data), np.squeeze(other.data)
        return a.shape == b.shape and bool(np.max(np.abs(a - b)) <= tol)


def save_image(path, data, sampling: float = 1.0) -> None:
    img = Image(np.asarray(data, dtype=np.float32))
    img.header.sampling = sampling
    img.write(path)


def load_image(path) -> np.ndarray:
    return Image(path).data
