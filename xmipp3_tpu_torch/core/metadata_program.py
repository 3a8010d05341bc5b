"""XmippMetadataProgram — the batched per-image pipeline base — and the
batch loading of the images that metadata rows name.

Counterpart of the reference package's core/metadata_program.py.
`load_image_rows` reads the 'image' column of a chunk of rows, and
`BatchPrefetcher` reads the next chunk on a host thread while the card
works on the current one (the loader thread touches numpy only).

XmippMetadataProgram: subclasses override `processBatch(imgs, rows)` on a
float32 (B, Y, X) batch (a numpy array read by the loader; the result may
be a tensor on the card or a numpy array), or `processImage` for per-item
programs. The base iterates the input, manages -i/-o/--oroot and applies
the rows' geometry on read (apply_geo programs). The card is resolved from
--device before preProcess (self.device).

Output semantics:
  -i metadata (.xmd/.star/.sel) or stack (.mrcs/.stk) or single image
  -o output stack/metadata/image (absent -> in place, over the input)
  --oroot per-image output root
  --save_metadata_stack [md] writes the output metadata table
  --resume skips rows whose itemId the output metadata already holds
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.filename import as_filename
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device

_MD_EXTS = {"xmd", "sel", "doc", "star", "ctfparam"}
_STACK_EXTS = ("mrcs", "stk", "mrc", "img", "hed", "em", "ser", "h5",
               "hdf5", "hdf", "vol", "spi", "xmp", "st", "ali")


def is_metadata_file(fn) -> bool:
    return as_filename(fn).ext in _MD_EXTS


def load_image_rows(rows: list[dict]) -> np.ndarray:
    """Batch-load the 'image' column of metadata rows as (n, Y, X) float32.

    Consecutive rows that name slices of one stack go through
    Image.read_slices in one call (one open, one read per run of
    consecutive slices): the data-loader hot path for big particle sets."""
    n = len(rows)
    out: list = [None] * n
    i = 0
    while i < n:
        fn = as_filename(rows[i]["image"])
        if fn.slice_index is None:
            out[i] = np.squeeze(Image(rows[i]["image"]).data)
            i += 1
            continue
        j = i
        idxs = []
        while j < n:
            fj = as_filename(rows[j]["image"])
            if fj.path != fn.path or fj.slice_index is None:
                break
            idxs.append(fj.slice_index - 1)
            j += 1
        out[i:j] = Image.read_slices(fn.path, idxs)
        i = j
    return np.stack(out).astype(np.float32)


class BatchPrefetcher:
    """Double-buffered batch loader: loads batch i+1 on a host thread while
    the device computes on batch i. Iterating yields (start, rows, images)
    per batch; an error in the loader is raised in the consumer."""

    def __init__(self, rows: list[dict], batch_size: int, loader=None,
                 depth: int = 2):
        self._rows = rows
        self._bs = batch_size
        self._loader = loader or load_image_rows
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._t = threading.Thread(target=self._produce, daemon=True)
        self._t.start()

    def _produce(self):
        try:
            for s in range(0, len(self._rows), self._bs):
                chunk = self._rows[s:s + self._bs]
                self._q.put((s, chunk, self._loader(chunk)))
        except Exception as e:
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item


class XmippMetadataProgram(XmippProgram):
    #: subclasses may set a preferred device batch size
    batch_size = 256
    produces_an_output = True
    apply_geo = False

    def defineParams(self):
        self.addParamsLine(" -i <input_file>   : Input metadata, stack, or image")
        self.addParamsLine("   alias --input;")
        if self.produces_an_output:
            self.addParamsLine(" [-o <output_file=\"\">]  : Output stack, metadata or image")
            self.addParamsLine("   alias --output;")
            self.addParamsLine(" [--oroot <root=\"\">]    : Rootname for per-image outputs")
        self.addParamsLine(" [--save_metadata_stack <output_md=\"\">] : Write output metadata")
        self.addParamsLine(" [--keep_input_columns]  : Keep input metadata columns")
        self.addParamsLine(" [--dont_apply_geo]      : Do not apply metadata transformations")
        self.addParamsLine(" [--geo_convention <c=native>] : Geometry-row interpretation when applying on read")
        self.addParamsLine("    where <c>")
        self.addParamsLine("      native : this framework's pose contract (M_x^f R(-psi) T(s))")
        self.addParamsLine("      xmipp  : reference readApplyGeo semantics, for metadata written by the reference/Scipion (ops.geo.read_apply_geo)")
        self.addParamsLine(" [--mode <mode=overwrite>] : Output file write mode")
        self.addParamsLine("    where <mode>")
        self.addParamsLine("      overwrite   : Replace output")
        self.addParamsLine("      append      : Append to output")
        self.addParamsLine(" [--resume]              : Skip rows already present in the output metadata")
        self.defineProcessParams()

    def defineProcessParams(self):
        """Subclass hook for program-specific params."""

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.fn_out = self.getParam("-o") if (self.produces_an_output and
                                              self.checkParam("-o")) else ""
        self.oroot = self.getParam("--oroot") if self.checkParam("--oroot") else ""
        self.fn_out_md = (self.getParam("--save_metadata_stack")
                          if self.checkParam("--save_metadata_stack") else "")
        self.do_apply_geo = self.apply_geo and not self.checkParam("--dont_apply_geo")
        self.geo_convention = (self.getParam("--geo_convention")
                               if self.checkParam("--geo_convention")
                               else "native")
        self.resume = self.checkParam("--resume")
        self.device_arg = self.getParam("--device")
        self.readProcessParams()

    def readProcessParams(self):
        """Subclass hook."""

    # ------------------------------------------------------------------
    def setup_input(self):
        fn = as_filename(self.fn_in)
        self.single_image = False
        if is_metadata_file(fn):
            self.mdIn = MetaData(fn)
            if self.mdIn.isEmpty():
                raise XmippError(ErrCode.MD_NOACTIVE, f"empty metadata {fn}")
        else:
            img = Image()
            img.read(fn, header_only=True)
            n = img.header.n_images
            if n > 1:
                self.mdIn = MetaData.fromRows(
                    [{"image": f"{i + 1:06d}@{fn.path}", "enabled": 1,
                      "itemId": i + 1} for i in range(n)])
            else:
                self.mdIn = MetaData.fromRows(
                    [{"image": str(fn), "enabled": 1, "itemId": 1}])
                self.single_image = img.header.shape[1] == 1
        self.mdIn.removeDisabled()

    def load_batch(self, rows: list[dict]) -> np.ndarray:
        arr = load_image_rows(rows)
        if self.do_apply_geo and arr.ndim == 3:
            psi_or_shift = any(
                r.get(k) for r in rows
                for k in ("anglePsi", "shiftX", "shiftY", "flip")) or any(
                abs(float(r.get("scale", 1.0) or 1.0) - 1.0) > 1e-6
                for r in rows)
            if psi_or_shift:
                arr = self.apply_geometry_batch(arr, rows)
        return arr

    def apply_geometry_batch(self, arr, rows):
        """The rows' geometry applied to a numpy batch, on the CPU (it runs
        in the loader thread): the native convention bilinearly, or with
        --geo_convention xmipp the reference readApplyGeo (B-spline)."""
        from xmipp3_tpu_torch.ops.geo import (apply_affine_2d,
                                              apply_md_geometry,
                                              metadata_alignment_matrices,
                                              read_apply_geo)
        psi = np.array([r.get("anglePsi", 0.0) for r in rows], np.float32)
        sx = np.array([r.get("shiftX", 0.0) for r in rows], np.float32)
        sy = np.array([r.get("shiftY", 0.0) for r in rows], np.float32)
        flip = np.array([bool(r.get("flip", 0)) for r in rows])
        scale = np.array([float(r.get("scale", 1.0) or 1.0) for r in rows],
                         np.float32)
        if self.geo_convention == "xmipp":
            return read_apply_geo(arr, psi, sx, sy, flip, scale, order=3,
                                  device="cpu").numpy()
        if np.any(np.abs(scale - 1.0) > 1e-6):
            A = metadata_alignment_matrices(psi, sx, sy, flip, scale,
                                            device="cpu")
            return apply_affine_2d(arr, A, order=1, device="cpu").numpy()
        return apply_md_geometry(arr, psi, sx, sy, flip,
                                 device="cpu").numpy()

    # ------------------------------------------------------------------
    def preProcess(self):
        pass

    def postProcess(self):
        pass

    def processImage(self, img: np.ndarray, row: dict):
        raise XmippError(ErrCode.NOT_IMPLEMENTED,
                         f"{self.name}: processImage/processBatch")

    def processBatch(self, imgs: np.ndarray, rows: list[dict]):
        return np.stack([_host(self.processImage(imgs[i], rows[i]))
                         for i in range(len(rows))])

    # ------------------------------------------------------------------
    def _skip_done_rows(self):
        """Rerunable contract (reference core/rerunable_program.h): with
        --resume, rows whose itemId already appears in the output metadata
        are skipped and previous results are kept."""
        self._resumed_rows = []
        if not (self.resume and self.fn_out and is_metadata_file(self.fn_out)
                and os.path.exists(as_filename(self.fn_out).path)):
            return
        done = MetaData(self.fn_out)
        if done.containsLabel("itemId"):
            done_ids = set(done.getColumn("itemId").tolist())
            keep = [i for i in self.mdIn
                    if self.mdIn.getValue("itemId", i) not in done_ids]
            self._resumed_rows = list(done.iterRows())
            self.mdIn._df = self.mdIn.df.loc[keep].reset_index(drop=True)

    def run(self):
        self.device = resolve_device(self.device_arg)
        self.setup_input()
        self._skip_done_rows()
        self.preProcess()
        rows = list(self.mdIn.iterRows())
        out_is_stack = bool(self.fn_out) and not is_metadata_file(self.fn_out)
        in_place = not self.fn_out and not self.oroot
        results: list[np.ndarray] = []
        out_rows: list[dict] = []
        # double-buffered loader: batch i+1 reads from disk while batch i
        # runs on the card
        batches = iter(BatchPrefetcher(rows, self.batch_size,
                                       loader=self.load_batch))
        while True:
            with timed_phase("read images"):     # the wait for the loader
                item = next(batches, None)
            if item is None:
                break
            _, chunk, imgs = item
            with timed_phase("process"):
                out = _host(self.processBatch(imgs, chunk))
            results.extend(out)
            out_rows.extend(dict(r) for r in chunk)
        if self.produces_an_output and results:
            with timed_phase("write outputs"):
                self._write_outputs(results, out_rows, out_is_stack,
                                    in_place)
        else:
            self.mdOut = MetaData.fromRows(out_rows)
        self.postProcess()

    def _write_outputs(self, results, out_rows, out_is_stack, in_place):
        if self.oroot:
            oext = getattr(self, "oroot_ext", "") or "mrc"
            for i, r in enumerate(out_rows):
                fn_i = f"{self.oroot}{i + 1:06d}.{oext}"
                save_image(fn_i, results[i])
                r["image"] = fn_i
        elif out_is_stack or in_place:
            target = self.fn_out if out_is_stack else \
                as_filename(self.fn_in).path
            if len(results) == 1 and (self.single_image or
                                      results[0].ndim == 3):
                save_image(target, results[0])
                out_rows[0]["image"] = target
            else:
                if as_filename(target).ext not in _STACK_EXTS:
                    # metadata input, stack output beside it
                    target = os.path.splitext(target)[0] + ".mrcs"
                save_image(target, np.stack(results))
                for i, r in enumerate(out_rows):
                    r["image"] = f"{i + 1:06d}@{target}"
        self.mdOut = MetaData.fromRows(self._resumed_rows + out_rows)
        if "itemId" in self.mdOut.df.columns and len(self._resumed_rows):
            self.mdOut.sort("itemId")
        if self.fn_out and is_metadata_file(self.fn_out):
            self.mdOut.write(self.fn_out)
        if self.fn_out_md:
            self.mdOut.write(self.fn_out_md)


def _host(out) -> np.ndarray:
    """A batch result (a tensor on any device, or an array) as a numpy
    array."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)
