"""Image utility programs: resize, convert, header, statistics, histogram.

Contracts: the reference package's programs/image_misc.py (reference
image_resize/image_convert/image_header/image_statistics/image_histogram
program CLIs). The resize, the statistics and the histogram run on the
program's device (--device; the card by default): the statistics in
float64, the histogram's bins by numpy's rule (float64 edges from
linspace, the last bin closed) so that its counts equal the reference's.
image_convert moves no pixel values (only the rows' geometry, applied on
read as in the reference, and the rewrite to the output type on the host),
and image_header reads and patches file headers on the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.resize import fourier_resize_2d, spline_resize_2d


class ProgImageResize(XmippMetadataProgram):
    name = "xmipp_image_resize"

    def defineProcessParams(self):
        self.addUsageLine("Resize images (fourier = band-limited, spline = interpolation).")
        self.addParamsLine("[--dim <x> <y=-1>]   : New dimensions")
        self.addParamsLine("[--factor <f=1>]     : Resize factor (0.5 halves)")
        self.addParamsLine("[--fourier]          : Use Fourier crop/pad (default spline)")
        self.addParamsLine("[--interp <i=spline>] : spline | linear")

    def readProcessParams(self):
        self.dim = None
        self.factor = None
        if self.checkParam("--dim"):
            x = self.getIntParam("--dim", 0)
            y = self.getIntParam("--dim", 1)
            self.dim = (x, x if y < 0 else y)
        elif self.checkParam("--factor"):
            self.factor = self.getDoubleParam("--factor")
        self.use_fourier = self.checkParam("--fourier")
        self.order = 1 if (self.checkParam("--interp") and
                           self.getParam("--interp") == "linear") else 3

    def processBatch(self, imgs, rows):
        H, W = imgs.shape[-2:]
        if self.dim:
            ow, oh = self.dim
        else:
            oh, ow = int(round(H * self.factor)), int(round(W * self.factor))
        if self.use_fourier:
            return fourier_resize_2d(imgs, oh, ow, device=self.device)
        return spline_resize_2d(imgs, oh, ow, order=self.order,
                                device=self.device)


_DEPTHS = {
    "uint8": np.uint8, "int8": np.int8, "uint16": np.uint16,
    "int16": np.int16, "uint32": np.uint32, "int32": np.int32,
    "long": np.int64, "float": np.float32, "double": np.float64,
}


class ProgImageConvert(XmippMetadataProgram):
    """Reference contract: ProgConvImg (data/xmipp_image_convert.cpp:85-134):
    --oext per-image format, --type, --depth bit depth, --swap endianness,
    --range_adjust / --dont_convert gray-level handling, --append stacks."""
    name = "xmipp_image_convert"
    apply_geo = True   # the reference converts WITH geometry unless
    #                    --dont_apply_geo (ProgConvImg, XmippMetadataProgram)

    def defineProcessParams(self):
        self.addUsageLine("Convert between image formats (by output extension).")
        self.addParamsLine("[--type <output_type=auto>] : auto|img|stk|vol")
        self.addParamsLine("   alias -t;")
        self.addParamsLine("[--oext <extension=\"\">] : Output format extension for --oroot outputs (img|inf|raw|mrc|spi|xmp|tif)")
        self.addParamsLine("[--depth <bit_depth=default>] : default|uint8|int8|uint16|int16|uint32|int32|long|float|double")
        self.addParamsLine("   alias -d;")
        self.addParamsLine("[--swap <type=arch>] : Swap output endianness: arch|little|big")
        self.addParamsLine("[--range_adjust] : Linearly rescale gray values to fill the output bit-depth range")
        self.addParamsLine("   alias -r;")
        self.addParamsLine("[--dont_convert] : Do not rescale gray levels when narrowing bit depth")
        self.addParamsLine("[--append] : Append the input to the output stack instead of overwriting it")
        self.addParamsLine("   alias -a;")

    def readProcessParams(self):
        self.depth = (self.getParam("--depth")
                      if self.checkParam("--depth") else "default")
        self.range_adjust = self.checkParam("--range_adjust")
        self.append = self.checkParam("--append")
        self.oext = self.getParam("--oext") if self.checkParam("--oext") else ""
        self.oroot_ext = self.oext          # per-image outputs honor --oext
        self.swap = self.getParam("--swap") if self.checkParam("--swap") else ""

    def processBatch(self, imgs, rows):
        return imgs

    def _out_dtype(self):
        dt = _DEPTHS.get(self.depth)
        if dt is None:
            return None
        from xmipp3_tpu_torch.core.image import _MRC_EXTS
        ext = os.path.splitext(self.fn_out or "")[1].lstrip(".").lower()
        if ext in _MRC_EXTS:
            # nearest MRC container mode (modes 0/1/2/6/12): uint8 data
            # stores as mode 0 int8; wide ints fall back to float32
            m = {np.uint8: np.int8, np.int8: np.int8, np.int16: np.int16,
                 np.uint16: np.uint16, np.float32: np.float32}
            return m.get(dt, np.float32)
        # Spider containers are float32-only
        return np.float32

    def run(self):
        super().run()
        target = self.fn_out or ""
        if not target or not os.path.exists(target):
            return
        dt = self._out_dtype()
        needs_rewrite = (dt is not None or self.range_adjust or
                         self.swap in ("big", "arch") or
                         (self.append and self._append_prior))
        if not needs_rewrite:
            return
        arr = np.asarray(Image(target).data, np.float64)
        if dt is not None and np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            if self.checkParam("--dont_convert"):
                pass                       # raw cast, truncation allowed
            elif self.range_adjust:
                lo, hi = float(arr.min()), float(arr.max())
                s = ((info.max - info.min) / (hi - lo)) if hi > lo else 1.0
                arr = (arr - lo) * s + info.min
            arr = np.clip(np.rint(arr), info.min, info.max)
        out = arr.astype(dt or np.float32)
        if self.append and self._append_prior and \
                os.path.exists(self._append_prior):
            prior = Image(self._append_prior).data
            if prior.ndim == 2:
                prior = prior[None]
            cur = out if out.ndim >= 3 else out[None]
            out = np.concatenate([prior.astype(out.dtype), cur])
            os.unlink(self._append_prior)
        self._write_typed(target, out)

    def _write_typed(self, target, out):
        from xmipp3_tpu_torch.core.image import _MRC_EXTS, write_mrc, write_spider
        ext = os.path.splitext(target)[1].lstrip(".").lower()
        if ext in _MRC_EXTS:
            write_mrc(target, out, dtype=out.dtype)
            if self.swap in ("big", "arch"):
                self._byteswap_mrc(target, out.dtype)
        else:
            write_spider(target, np.asarray(out, np.float32))
            if self.swap in ("big", "arch"):
                self._byteswap_flat(target, np.float32)

    @staticmethod
    def _byteswap_mrc(path, dtype):
        """Rewrite an LE MRC file big-endian (header words + data elements;
        machst set to the big-endian stamp 0x11110000)."""
        with open(path, "rb") as f:
            hdr = np.frombuffer(f.read(1024), dtype="<i4").copy()
            data = np.fromfile(f, dtype=np.dtype(dtype).newbyteorder("<"))
        hdr[53] = int.from_bytes(bytes([0x11, 0x11, 0, 0]), "little")
        with open(path, "wb") as f:
            f.write(hdr.astype(">i4").tobytes())
            f.write(data.astype(np.dtype(dtype).newbyteorder(">")).tobytes())

    @staticmethod
    def _byteswap_flat(path, dtype):
        """Byte-swap every 4-byte word of a Spider file (header and data are
        homogeneously float32, so a flat swap flips the whole file's
        endianness; our reader autodetects either order)."""
        raw = np.fromfile(path, dtype="<f4")
        raw.astype(">f4").tofile(path)

    def setup_input(self):
        super().setup_input()
        # snapshot pre-existing output for --append before the base
        # overwrites it
        self._append_prior = ""
        if self.append and self.fn_out and os.path.exists(self.fn_out):
            import shutil
            import tempfile
            fd, tmp = tempfile.mkstemp(
                suffix=os.path.splitext(self.fn_out)[1])
            os.close(fd)
            shutil.copy(self.fn_out, tmp)
            self._append_prior = tmp


class ProgImageHeader(XmippProgram):
    """Reference contract: ProgHeader (reconstruction/image_header.cpp:52-67):
    --print/--extract/--assign/--reset/--sampling_rate modes operating on
    per-image header geometry, --round_shifts, --tree for HDF5."""
    name = "xmipp_image_header"

    def defineParams(self):
        self.addUsageLine("Inspect or edit image header information.")
        self.addParamsLine(" -i <input_file> : Image, stack or metadata")
        self.addParamsLine("[--print <decompose=0>] : Print header geometry; decompose=1 prints each stack image")
        self.addParamsLine("   alias -p;")
        self.addParamsLine("[--extract] : Write header geometry of every image to -o metadata")
        self.addParamsLine("   alias -e;")
        self.addParamsLine("   requires -o;")
        self.addParamsLine("[--assign] : Write metadata geometry into the image file headers")
        self.addParamsLine("   alias -a;")
        self.addParamsLine("[--reset] : Reset geometry in image file headers")
        self.addParamsLine("   alias -r;")
        self.addParamsLine("[--tree] : Print the dataset tree of an HDF5 container")
        self.addParamsLine("   alias -t;")
        self.addParamsLine("[--sampling_rate <Ts=-1>] : Set sampling rate (A/px) in headers; without a value prints the current one")
        self.addParamsLine("   alias -s;")
        self.addParamsLine("[--round_shifts] : Round shifts to integers")
        self.addParamsLine("[-o <output_file=\"\">] : Output metadata (--extract)")

    def _image_files(self, fn):
        from xmipp3_tpu_torch.core.metadata_program import is_metadata_file
        if is_metadata_file(fn):
            md = MetaData(fn)
            return [str(v) for v in md.getColumn("image")], md
        return [fn], None

    def run(self):
        from xmipp3_tpu_torch.core.filename import as_filename
        from xmipp3_tpu_torch.core.image import (get_image_sampling,
                                           read_spider_geo,
                                           set_image_sampling,
                                           write_spider_geo)
        fn = self.getParam("-i")
        round_shifts = self.checkParam("--round_shifts")

        if self.checkParam("--tree"):
            import h5py
            with h5py.File(as_filename(fn).path, "r") as h5:
                h5.visit(lambda name: print(name))
            return

        if self.checkParam("--sampling_rate"):
            ts = self.getDoubleParam("--sampling_rate")
            files, _md = self._image_files(fn)
            for f in files:
                path = as_filename(f).path
                if ts > 0:
                    set_image_sampling(path, ts)
                else:
                    print(f"{path}: sampling rate = "
                          f"{get_image_sampling(path):.4f} A/px")
            return

        if self.checkParam("--extract"):
            files, _md = self._image_files(fn)
            out_rows = []
            for f in files:
                path = as_filename(f).path
                for i, g in enumerate(read_spider_geo(path)):
                    if round_shifts:
                        for k in ("shiftX", "shiftY", "shiftZ"):
                            g[k] = float(round(g[k]))
                    g["image"] = f"{i + 1:06d}@{path}" if len(files) == 1 \
                        else f
                    out_rows.append(g)
            self.mdOut = MetaData.fromRows(out_rows)
            self.mdOut.write(self.getParam("-o"))
            return

        if self.checkParam("--assign"):
            md = MetaData(fn)
            rows = list(md.iterRows())
            # patch by the NNNNNN@stack slot embedded in each image name
            # (row order is only a fallback when no index is present), so a
            # sorted/filtered metadata still assigns geometry correctly
            by_file: dict = {}
            fallback_pos: dict = {}
            for r in rows:
                f = as_filename(str(r.get("image", "")))
                slots = by_file.setdefault(f.path, {})
                if f.prefix.isdigit():
                    slot = int(f.prefix) - 1
                else:
                    slot = fallback_pos.get(f.path, 0)
                fallback_pos[f.path] = slot + 1
                slots[slot] = r
            for path, slots in by_file.items():
                write_spider_geo(path, slots, round_shifts=round_shifts)
            return

        if self.checkParam("--reset"):
            files, _md = self._image_files(fn)
            for f in files:
                write_spider_geo(as_filename(f).path, reset=True)
            return

        # default / --print
        decompose = (self.getIntParam("--print") == 1
                     if self.checkParam("--print") else False)
        files, _md = self._image_files(fn)
        for f in files:
            path = as_filename(f).path
            img = Image()
            img.read(path, header_only=True)
            n, z, y, x = img.header.shape
            print(f"Image file       : {f}")
            print(f"Dimensions       : {n} x {z} x {y} x {x} "
                  "((N)Objects x Zdim x Ydim x Xdim)")
            print(f"Data type        : {img.header.dtype}")
            print(f"Sampling rate    : {img.header.sampling:.4f} A/px")
            print(f"Format           : {img.header.format}")
            if decompose and img.header.format == "spider":
                for i, g in enumerate(read_spider_geo(path)):
                    print(f"  {i + 1:06d}: rot={g['angleRot']:.2f} "
                          f"tilt={g['angleTilt']:.2f} "
                          f"psi={g['anglePsi']:.2f} "
                          f"shift=({g['shiftX']:.2f},{g['shiftY']:.2f},"
                          f"{g['shiftZ']:.2f})")


class ProgImageStatistics(XmippMetadataProgram):
    """Reference contract: ProgStatistics
    (reconstruction/image_statistics.cpp:60-260): per-image + mean stats,
    --short_format / --show_angles print modes, --save_mask, and
    --save_image_stats average/stddev images."""
    name = "xmipp_image_statistics"
    produces_an_output = False

    def defineProcessParams(self):
        self.addUsageLine("Display min/max/avg/stddev statistics of images.")
        self.addParamsLine("[-o <metadata=\"\">] : Save the statistics in this metadata file")
        self.addParamsLine("[--short_format] : Do not show labels for statistics")
        self.addParamsLine("[--show_angles] : Also show rot/tilt/psi of each image")
        self.addParamsLine("[--save_mask <maskFileName=\"\">] : Save the statistics mask")
        self.addParamsLine("[--save_image_stats <stats_root=\"\">] : Save average and standard deviation images")
        self.addParamsLine("[--mask <type=circular> <R=-1>] : Restrict statistics to a circular mask of radius R (R<0 = inscribed)")

    def run(self):
        self.device = resolve_device(self.device_arg)
        self.setup_input()
        rows = list(self.mdIn.iterRows())
        imgs = self.load_batch(rows)
        short = self.checkParam("--short_format")
        show_angles = self.checkParam("--show_angles")
        mask = None
        if self.checkParam("--mask"):
            from xmipp3_tpu_torch.ops.mask import circular_mask
            if self.getParam("--mask", 0) != "circular":
                # the reference reads only R and always masks a circle
                # (ROADMAP.md section 3, item 11)
                raise XmippError(ErrCode.ARG_INCORRECT,
                                 f"--mask {self.getParam('--mask', 0)}: "
                                 "only the circular mask is implemented")
            R = self.getDoubleParam("--mask", 1)
            mask = np.asarray(circular_mask(
                imgs.shape[1:], None if R < 0 else R)) > 0
            if self.checkParam("--save_mask") and \
                    self.getParam("--save_mask"):
                save_image(self.getParam("--save_mask"),
                           mask.astype(np.float32))
        x = torch.as_tensor(imgs, device=self.device)
        vals = (x[:, torch.as_tensor(mask, device=self.device)]
                if mask is not None else x.reshape(len(rows), -1))
        vals = vals.to(torch.float64)
        mins, maxs = (v.cpu().numpy() for v in vals.aminmax(dim=1))
        avgs = vals.mean(dim=1).cpu().numpy()
        stds = vals.std(dim=1, correction=0).cpu().numpy()
        out_rows = []
        for i, r in enumerate(rows):
            if self.verbose:
                name = str(r.get("image", ""))
                if short:
                    line = (f"{name} {mins[i]:10f} {maxs[i]:10f} "
                            f"{avgs[i]:10f} {stds[i]:10f}")
                else:
                    line = (f"{name} min={mins[i]:10f} max={maxs[i]:10f} "
                            f"avg={avgs[i]:10f} stddev={stds[i]:10f}")
                if show_angles:
                    line += (f" rot={float(r.get('angleRot', 0) or 0):10f}"
                             f" tilt={float(r.get('angleTilt', 0) or 0):10f}"
                             f" psi={float(r.get('anglePsi', 0) or 0):10f}")
                print(line)
            d = dict(r)
            d.update({"min": float(mins[i]), "max": float(maxs[i]),
                      "avg": float(avgs[i]), "stddev": float(stds[i])})
            out_rows.append(d)
        mn, mx = float(mins.mean()), float(maxs.mean())
        avg, std = float(avgs.mean()), float(stds.mean())
        print(f"min= {mn:.6g} max= {mx:.6g} avg= {avg:.6g} stddev= {std:.6g}")
        self.stats = dict(min=mn, max=mx, avg=avg, stddev=std)
        self.mdOut = MetaData.fromRows(out_rows)
        if self.checkParam("-o") and self.getParam("-o"):
            self.mdOut.write(self.getParam("-o"))
        if self.checkParam("--save_image_stats"):
            # mask is ignored for this operation (reference usage note)
            root = self.getParam("--save_image_stats")
            n = len(rows)
            x64 = x.to(torch.float64)
            avg_img = x64.mean(dim=0)
            if n > 1:
                var = (x64 ** 2).mean(dim=0) - avg_img ** 2
                var *= n / (n - 1)
                std_img = var.abs().sqrt()
            else:
                std_img = torch.zeros_like(avg_img)
            save_image(root + "average.xmp",
                       avg_img.to(torch.float32).cpu().numpy())
            save_image(root + "stddev.xmp",
                       std_img.to(torch.float32).cpu().numpy())


class ProgImageHistogram(XmippMetadataProgram):
    name = "xmipp_image_histogram"
    produces_an_output = False

    def defineProcessParams(self):
        self.addUsageLine("Compute the histogram of image values.")
        self.addParamsLine("[-o <text_file=\"\">] : Output text file with the histogram")
        self.addParamsLine("[--steps <n=100>]  : Number of bins")
        self.addParamsLine("[--range <min> <max>] : Value range (default: data range)")
        self.addParamsLine("[--norm] : Normalize the histogram to unit area")

    def run(self):
        self.device = resolve_device(self.device_arg)
        self.setup_input()
        rows = list(self.mdIn.iterRows())
        x = torch.as_tensor(self.load_batch(rows), device=self.device)
        nbins = self.getIntParam("--steps") if self.checkParam("--steps") else 100
        if self.checkParam("--range"):
            lo = self.getDoubleParam("--range", 0)
            hi = self.getDoubleParam("--range", 1)
        else:
            lo, hi = (float(v) for v in x.aminmax())
        counts, edges = histogram(x, nbins, lo, hi)
        centers = 0.5 * (edges[:-1] + edges[1:])
        if self.checkParam("--norm"):
            width = (hi - lo) / nbins if hi > lo else 1.0
            total = counts.sum() * width
            vals = counts / total if total else counts.astype(float)
        else:
            vals = counts
        self.mdOut = MetaData.fromRows(
            [{"x": float(c), "count": float(n)}
             for c, n in zip(centers, vals)])
        if self.checkParam("-o") and self.getParam("-o"):
            fn_out = self.getParam("-o")
            if fn_out.endswith((".xmd", ".star", ".sel", ".doc")):
                self.mdOut.write(fn_out)
            else:
                with open(fn_out, "w") as f:
                    for c, n in zip(centers, vals):
                        f.write(f"{c:12.5f} {n}\n")
        elif self.verbose:
            for c, n in zip(centers, vals):
                print(f"{c:12.5f} {n}")


def histogram(x: torch.Tensor, nbins: int, lo: float, hi: float):
    """np.histogram(x, bins=nbins, range=(lo, hi)) of a float32 tensor on
    its device: (int64 counts, float32 edges) as numpy. Each value's bin
    follows numpy's rule for equal bins on float32 data: float32 edges from
    linspace, the index from float32 (x - lo) over the float64 width,
    corrected against the edges in float32; the last bin closed; values
    outside the range dropped. So the counts are numpy's."""
    if lo == hi:                       # numpy widens an empty range
        lo, hi = lo - 0.5, hi + 0.5
    edges = np.linspace(lo, hi, nbins + 1, dtype=np.float32)
    e = torch.as_tensor(edges, device=x.device)
    v = x.reshape(-1).to(torch.float32)
    v = v[(v >= lo) & (v <= hi)]
    f = (v - lo).to(torch.float64) / float(np.float64(hi) - np.float64(lo))
    idx = (f * nbins).to(torch.int64)
    idx[idx == nbins] -= 1
    idx -= (v < e[idx]).to(torch.int64)
    idx += ((v >= e[idx + 1]) & (idx != nbins - 1)).to(torch.int64)
    counts = torch.bincount(idx, minlength=nbins)
    return counts.cpu().numpy(), edges


PROGRAM = None  # multi-program module; see registry
