"""xmipp_image_align — 2-D alignment of a stack to a reference (or
reference-free with iterative average refinement), on the card.

Contract: reference align2d / image_align CLI (reconstruction/align2d.h:36),
with the flags of the reference package's programs/image_align.py; the
compute path is the batched aligner (ops.align). The whole stack is read as
one batch and aligned in chunks of `batch_size` images (each image is
aligned on its own, so the chunks change no result and bound the card's
memory); the reference-free average is taken over every chunk.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.align import (align_considering_mirrors,
                                        iterative_align)
from xmipp3_tpu_torch.ops.features import center_translationally
from xmipp3_tpu_torch.ops.geo import alignment_to_md_pose


def _align(ref, imgs, use_mirror: bool, max_shift: int, chunk: int):
    """(psi, sx, sy, flip, corr, aligned) of every image against ref (one
    (H,W) image, or one per image), in chunks of `chunk` images."""
    parts = []
    for lo in range(0, imgs.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        r = ref[sl] if ref.ndim == 3 else ref
        if use_mirror:
            parts.append(align_considering_mirrors(r, imgs[sl], n_iters=3,
                                                   max_shift=max_shift))
        else:
            psi, sx, sy, corr, aligned = iterative_align(
                r, imgs[sl], n_iters=3, max_shift=max_shift)
            parts.append((psi, sx, sy, torch.zeros_like(psi, dtype=torch.bool),
                          corr, aligned))
    return tuple(torch.cat(v) for v in zip(*parts))


def _pspc_reference(imgs, use_mirror: bool, max_shift: int, chunk: int,
                    verbose: int = 0):
    """Pyramidal pairwise combination initial reference (align2d.cpp
    do_pspc/alignPairs): at each level align image 2k+1 onto image 2k,
    average the pair, translationally center, carry any odd remainder up,
    until one image is left. Every pair at a level is aligned in one
    batched call, each image against its own reference."""
    level = imgs
    lev_no = 0
    while len(level) > 1:
        half = len(level) // 2
        refs = level[0:2 * half:2]
        movs = level[1:2 * half:2]
        aligned = _align(refs, movs, use_mirror, max_shift, chunk)[5]
        merged = center_translationally(0.5 * (refs + aligned))
        if len(level) % 2:
            merged = torch.cat([merged, level[-1:]])
        if verbose:
            print(f"pspc level {lev_no}: {len(level)} -> {len(merged)}")
        level = merged
        lev_no += 1
    return level[0]


def _avg_name(fn: str) -> str:
    """stack.mrcs -> stack_avg.mrcs: the reference-free average beside the
    aligned stack (the reference package inserts "_avg" before the first
    dot of the whole path, a directory's dot included; ROADMAP.md §3)."""
    root, ext = os.path.splitext(fn)
    return root + "_avg" + ext


class ProgImageAlign(XmippMetadataProgram):
    name = "xmipp_image_align"
    batch_size = 1024

    def defineProcessParams(self):
        self.addUsageLine("Align a stack of images: to a reference image, or "
                          "reference-free (iterative average).")
        self.addParamsLine("[--ref <reference=\"\">]  : Reference image; if absent, reference-free")
        self.addParamsLine("[--iter <n=5>]        : Reference-free refinement iterations")
        self.addParamsLine("[--max_shift <s=-1>]  : Maximum shift (pixels; -1 = dim/4)")
        self.addParamsLine("[--dont_mirror]       : Do not check mirrored alignment")
        self.addParamsLine("   alias --do_not_check_mirrors;")
        self.addParamsLine("[--pspc]              : Build the first reference by pyramidal pairwise combination (align2d.cpp do_pspc) instead of the plain average")
        self.addParamsLine("[--oaligned <stk=\"\">] : Also write the aligned stack here")

    def readProcessParams(self):
        self.fn_ref = self.getParam("--ref") if self.checkParam("--ref") else ""
        self.n_ref_iters = self.getIntParam("--iter") if self.checkParam("--iter") else 5
        self.max_shift = self.getIntParam("--max_shift") if self.checkParam("--max_shift") else -1
        self.use_mirror = not self.checkParam("--dont_mirror")
        self.fn_aligned = self.getParam("--oaligned") if self.checkParam("--oaligned") else ""

    def run(self):
        self.device = resolve_device(self.device_arg)
        # full float32: no TF32 in library products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.setup_input()
        rows = list(self.mdIn.iterRows())
        with timed_phase("read images"):
            imgs = torch.as_tensor(self.load_batch(rows), device=self.device)
        B, H, W = imgs.shape
        max_shift = self.max_shift if self.max_shift > 0 else H // 4
        chunk = self.batch_size

        with timed_phase("reference"):
            if self.fn_ref:
                ref = torch.as_tensor(
                    np.squeeze(Image(self.fn_ref).data).astype(np.float32),
                    device=self.device)
            elif self.checkParam("--pspc"):
                ref = _pspc_reference(imgs, self.use_mirror, max_shift,
                                      chunk, self.verbose)
            else:
                # reference-free: start from the plain average, iterate
                ref = imgs.mean(dim=0)

        n_outer = 1 if self.fn_ref else self.n_ref_iters
        for it in range(n_outer):
            with timed_phase("align"):
                psi, sx, sy, flip, corr, aligned = _align(
                    ref, imgs, self.use_mirror, max_shift, chunk)
                if not self.fn_ref:
                    ref = aligned.mean(dim=0)
                mean_corr = float(corr.mean())
            if self.verbose:
                print(f"iter {it + 1}: mean corr {mean_corr:.4f}")

        # convert applied-alignment params to the stored metadata pose
        # convention (ops.geo.alignment_to_md_pose): the aligners return
        # aligned = T(s)R(ψ)·F·img with F the x-mirror of the input, the F
        # form the converter takes as it is. (The reference package adds
        # 180° to ψ of the mirrored rows here, and its rows then do not
        # reproduce its own aligned images; ROADMAP.md §3.)
        psi_md, sx_md, sy_md, _ = (v.cpu().numpy() for v in
                                   alignment_to_md_pose(psi, sx, sy, flip))
        flip = flip.cpu().numpy()
        corr = corr.cpu().numpy()
        for i, r in enumerate(rows):
            r["anglePsi"] = float(psi_md[i])
            r["shiftX"] = float(sx_md[i])
            r["shiftY"] = float(sy_md[i])
            r["flip"] = int(flip[i])
            r["maxCC"] = float(corr[i])
        with timed_phase("write outputs"):
            self.mdOut = MetaData.fromRows(rows)
            if self.fn_out:
                if self.fn_out.endswith((".stk", ".mrcs", ".mrc", ".spi",
                                         ".xmp")):
                    print(f"WARNING: -o {self.fn_out} is the output METADATA "
                          "(alignment parameters); use --oaligned for the "
                          "aligned image stack")
                self.mdOut.write(self.fn_out)
            if self.fn_aligned:
                save_image(self.fn_aligned, aligned.cpu().numpy())
                if not self.fn_ref:
                    save_image(_avg_name(self.fn_aligned),
                               aligned.mean(dim=0).cpu().numpy())
        self.postProcess()


PROGRAM = ProgImageAlign
