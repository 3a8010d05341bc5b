"""xmipp_movie_alignment_correlation: frame alignment by cross-correlation
(the FlexAlign path; reference movie_alignment_correlation_base.cpp
grammar), xmipp_movie_filter_dose and xmipp_movie_estimate_gain.

The movie goes to the card once (unless `--device cpu`); dark and gain
correction, binning, the global and local alignment, the warp, the dose
weights and the gain estimate run there. Under --mesh the patch axis of
the local alignment is sharded over the ranks, and only rank 0 computes
the averages and writes files.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import is_metadata_file
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.ops import movie as mops


def _load_movie(fn) -> np.ndarray:
    """A movie stack, or the frames a metadata lists, as (F, Y, X)."""
    if is_metadata_file(fn):
        md = MetaData(fn)
        return np.stack([np.squeeze(Image(r["image"]).data)
                         for r in md.iterRows()]).astype(np.float32)
    return Image.read_stack(fn)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


class ProgMovieAlignmentCorrelation(XmippProgram):
    name = "xmipp_movie_alignment_correlation"

    def defineParams(self):
        self.addUsageLine("Align a set of frames by cross-correlation of the frames")
        self.addParamsLine("   -i <metadata>               : Movie stack or metadata with frames")
        self.addParamsLine("  [-o <fn=\"out.xmd\">]          : Metadata with the shifts of each frame")
        self.addParamsLine("  [--maxShift <s=50>]          : Maximum shift allowed in A")
        self.addParamsLine("  [--sampling <Ts=1>]          : Sampling rate (A/pixel)")
        self.addParamsLine("  [--oaligned <fn=\"\">]         : Write the aligned movie stack")
        self.addParamsLine("  [--oavgInitial <fn=\"\">]      : Unaligned (initial) micrograph")
        self.addParamsLine("  [--oavg <fn=\"\">]             : Aligned micrograph")
        self.addParamsLine("  [--dark <fn=\"\">]             : Dark correction image")
        self.addParamsLine("  [--gain <fn=\"\">]             : Gain correction image (multiplied)")
        self.addParamsLine("  [--skipLocalAlignment]       : Only global alignment")
        self.addParamsLine("  [--controlPoints <x=6> <y=6> <t=5>] : BSpline control points")
        self.addParamsLine("  [--patches <x=7> <y=7>]      : Patches for local alignment")
        self.addParamsLine("  [--frameRange <n0=-1> <nF=-1>] : First and last frame to align (0-based)")
        self.addParamsLine("  [--frameRangeSum <n0=-1> <nF=-1>] : First and last frame to sum; must lie within --frameRange")
        self.addParamsLine("  [--bin <s=1>]                : Binning factor (>=1, may be fractional); output micrograph is binned")
        self.addParamsLine("  [--maxResForCorrelation <R=30>] : Maximum resolution used for the alignment correlations (A)")
        self.addParamsLine("  [--minLocalRes <R=500>]      : Minimal resolution (A) of patches during local alignment (sets the patch extent R/Ts px)")
        self.addParamsLine("  [--patchesAvg <avg=3>]       : Number of near frames averaged into each patch frame (GPU reference movie_alignment_correlation_gpu.cpp:40)")
        self.addParamsLine("  [--dose_per_frame <d=0>]     : e/A^2 per frame (enables dose weighting)")
        self.addParamsLine("  [--voltage <kV=300>]         : For dose weighting")
        from xmipp3_tpu_torch.parallel.cli import add_mesh_params
        add_mesh_params(self)

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.fn_out = self.getParam("-o")
        self.max_shift_A = self.getDoubleParam("--maxShift")
        self.Ts = self.getDoubleParam("--sampling")
        opt = lambda flag: self.getParam(flag) if self.checkParam(flag) \
            else ""
        self.fn_aligned = opt("--oaligned")
        self.fn_avg0 = opt("--oavgInitial")
        self.fn_avg = opt("--oavg")
        self.fn_dark = opt("--dark")
        self.fn_gain = opt("--gain")
        self.local = not self.checkParam("--skipLocalAlignment")
        self.patches = (self.getIntParam("--patches", 1),
                        self.getIntParam("--patches", 0))
        # binned sampling governs shifts/outputs (reference
        # movie_alignment_correlation_base.cpp:39-43: Ts *= binning)
        self.binning = self.getDoubleParam("--bin")
        if self.binning < 1.0:
            raise ValueError("Binning must be >= 1")
        self.Ts *= self.binning
        self.max_res_corr = self.getDoubleParam("--maxResForCorrelation")
        self.min_local_res = self.getIntParam("--minLocalRes")
        self.patches_avg = self.getIntParam("--patchesAvg")
        self.frame_range = (self.getIntParam("--frameRange", 0),
                            self.getIntParam("--frameRange", 1))
        self.sum_range = (self.getIntParam("--frameRangeSum", 0),
                          self.getIntParam("--frameRangeSum", 1))
        self.dose = self.getDoubleParam("--dose_per_frame") if \
            self.checkParam("--dose_per_frame") else 0.0
        self.kV = self.getDoubleParam("--voltage")
        self.device_arg = self.getParam("--device")
        from xmipp3_tpu_torch.parallel.cli import read_mesh_params
        read_mesh_params(self)

    def run(self):
        from xmipp3_tpu_torch.parallel.cli import maybe_init_distributed
        from xmipp3_tpu_torch.parallel.mesh import rank_device, world
        started = maybe_init_distributed(self)
        try:
            self.device = rank_device(self.device_arg) if world()[0] > 1 \
                else resolve_device(self.device_arg)
            self._align(world()[1] == 0)
        finally:
            if started:
                torch.distributed.destroy_process_group()

    def _frames(self):
        """The movie on the device, dark- and gain-corrected, cut to
        --frameRange and binned; and the --frameRangeSum slice in it."""
        with timed_phase("read movie"):
            frames = as_tensor(_load_movie(self.fn_in), self.device)
        with timed_phase("dark gain bin", sync=frames):
            if self.fn_dark:
                frames -= as_tensor(np.squeeze(Image(self.fn_dark).data),
                                    self.device)
            if self.fn_gain:
                frames *= as_tensor(np.squeeze(Image(self.fn_gain).data),
                                    self.device)
            # --frameRange / --frameRangeSum (reference checkSettings:
            # summing frames that were not aligned is not allowed)
            n0, nF = self.frame_range
            n0 = 0 if n0 < 0 else n0
            nF = len(frames) - 1 if nF < 0 else nF
            s0, sF = self.sum_range
            s0 = n0 if s0 < 0 else s0
            sF = nF if sF < 0 else sF
            if s0 < n0 or sF > nF:
                raise XmippError(ErrCode.ARG_INCORRECT,
                                 "Summing frames that were not aligned is "
                                 "not allowed (--frameRangeSum outside "
                                 "--frameRange)")
            frames = frames[n0:nF + 1]
            if self.binning > 1.0:
                from xmipp3_tpu_torch.ops.resize import fourier_resize_2d
                Hb = int(round(frames.shape[1] / self.binning)) & ~1
                Wb = int(round(frames.shape[2] / self.binning)) & ~1
                frames = torch.cat([fourier_resize_2d(frames[f:f + 1], Hb, Wb)
                                    for f in range(len(frames))])
        return frames, n0, slice(s0 - n0, sF - n0 + 1)

    def _align(self, writes: bool):
        frames, n0, sum_sel = self._frames()
        F, H, W = frames.shape
        if self.fn_avg0 and writes:
            save_image(self.fn_avg0, _host(frames.mean(dim=0)))

        max_shift_px = max(int(self.max_shift_A / self.Ts), 4)
        corr_n = None
        if self.checkParam("--maxResForCorrelation"):
            # align on a grid whose Nyquist matches the requested band
            # (reference LPF sigma = Ts*C/maxRes, base.cpp:208)
            corr_n = int(2 * H * self.Ts / self.max_res_corr)
            corr_n = max(64, min(corr_n - corr_n % 2, H, W))
        with timed_phase("global alignment"):
            pos = mops.global_align(frames, max_shift_px, corr_n=corr_n)
        self.positions = pos
        if self.verbose and writes:
            print("global per-frame shifts (px):")
            for i, (x, y) in enumerate(pos):
                print(f"  frame {i + 1}: {x:8.3f} {y:8.3f}")

        aligned = None
        if self.local and min(H, W) >= 128:
            if self.patches_avg < 1:
                raise XmippError(ErrCode.ARG_INCORRECT,
                                 "Patch averaging has to be at least 1")
            # requested patch extent from --minLocalRes (reference
            # getRequestedPatchSize: minLocalRes / Ts pixels)
            patch_px = max(int(self.min_local_res / self.Ts), 64) \
                if self.checkParam("--minLocalRes") else 256
            kw = dict(patches=self.patches, patch_size=patch_px,
                      max_shift_px=8, patches_avg=self.patches_avg)
            from xmipp3_tpu_torch.parallel.cli import resolve_mesh
            mesh, mode = resolve_mesh(self.mesh_mode, device=self.device_arg)
            if mesh is not None and self.verbose and writes:
                print(f"mesh: {mode} local alignment over {mesh.size} "
                      "devices")
            with timed_phase("local alignment"):
                if mesh is not None:
                    # patch axis sharded over the mesh (the FlexAlign
                    # stream pool, movie_alignment_correlation_gpu.cpp:649)
                    from xmipp3_tpu_torch.parallel.movie import \
                        local_align_mesh
                    field, cys, cxs = local_align_mesh(mesh, frames, pos,
                                                       **kw)
                else:
                    field, cys, cxs = mops.local_align(frames, pos, **kw)
            self.field = field
            if not writes:
                return
            total = field + pos[None, None]
            # gather-free tiled warp (Fourier-shifted Hann tiles); sum only
            # the --frameRangeSum window
            with timed_phase("warp"):
                avg = mops.warp_sum_frames_tiled(
                    frames[sum_sel], total[:, :, sum_sel], cys, cxs) \
                    / len(frames[sum_sel])
        else:
            if not writes:
                return
            dose_f = None
            if self.dose > 0:
                dose_f = mops.dose_filter(H, F, self.dose, self.Ts,
                                          voltage=self.kV,
                                          device=frames.device, width=W)
            with timed_phase("sum"):
                nsum = frames[sum_sel].shape[0]
                avg = mops.shift_sum_frames(
                    frames[sum_sel], -pos[sum_sel, 0], -pos[sum_sel, 1],
                    dose_f[sum_sel] if dose_f is not None else None) / \
                    (1.0 if dose_f is not None else nsum)
                if self.fn_aligned:
                    aligned = mops.shift_sum_frames_keep(frames, -pos[:, 0],
                                                         -pos[:, 1])

        with timed_phase("write"):
            if self.fn_avg:
                save_image(self.fn_avg, _host(avg), sampling=self.Ts)
            if self.fn_aligned:
                if aligned is None:
                    aligned = mops.shift_sum_frames_keep(frames, -pos[:, 0],
                                                         -pos[:, 1])
                save_image(self.fn_aligned, _host(aligned), sampling=self.Ts)
            MetaData.fromRows([
                {"image": f"{n0 + i + 1:06d}@{self.fn_in}",
                 "shiftX": float(pos[i, 0]),
                 "shiftY": float(pos[i, 1]), "itemId": n0 + i + 1}
                for i in range(F)]).write(self.fn_out)


class ProgMovieFilterDose(XmippProgram):
    name = "xmipp_movie_filter_dose"

    def defineParams(self):
        self.addUsageLine("Apply dose-dependent frequency weighting "
                          "(Grant & Grigorieff) to movie frames.")
        self.addParamsLine("   -i <movie>       : Input movie stack")
        self.addParamsLine("  [-o <movie=out.mrcs>] : Output weighted stack")
        self.addParamsLine("  [--frameRange <n0=-1> <nF=-1>] : First and "
                           "last frame to filter, frame numbers start at 0")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (A)")
        self.addParamsLine("  [--dosePerFrame <d=2>] : e/A^2 per frame")
        self.addParamsLine("        alias --dose_per_frame;")
        self.addParamsLine("  [--preExposure <d=0>]  : Dose before first "
                           "frame (e/A^2)")
        self.addParamsLine("        alias --pre_dose;")
        self.addParamsLine("  [--accVoltage <kV=300>] : Acceleration voltage")
        self.addParamsLine("        alias --voltage;")

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.fn_out = self.getParam("-o")
        self.Ts = self.getDoubleParam("--sampling")
        self.dose = self.getDoubleParam("--dosePerFrame")
        self.pre = self.getDoubleParam("--preExposure")
        self.kV = self.getDoubleParam("--accVoltage")
        self.n0 = self.getIntParam("--frameRange", 0)
        self.nF = self.getIntParam("--frameRange", 1)

    def run(self):
        device = resolve_device(self.getParam("--device"))
        with timed_phase("read movie"):
            frames = as_tensor(_load_movie(self.fn_in), device)
        pre = self.pre
        if self.n0 >= 0 or self.nF >= 0:
            n0 = max(self.n0, 0)
            nF = self.nF if self.nF >= 0 else frames.shape[0] - 1
            frames = frames[n0:nF + 1]
            # pre-exposure grows with the skipped leading frames
            pre = pre + n0 * self.dose
        F, H, W = frames.shape
        with timed_phase("dose filter", sync=frames):
            q = mops.dose_filter(H, F, self.dose, self.Ts, pre, self.kV,
                                 device=device, width=W)
            out = mops.filter_frames(frames, q)
        with timed_phase("write"):
            save_image(self.fn_out, _host(out), sampling=self.Ts)


class ProgMovieEstimateGain(XmippProgram):
    """Full reference surface movie_estimate_gain.cpp:33-530."""
    name = "xmipp_movie_estimate_gain"

    def defineParams(self):
        self.addUsageLine("Estimate the gain image of a camera from a "
                          "movie (iterative rank-histogram method).")
        self.addParamsLine("   -i <movie>   : Input movie")
        self.addParamsLine("  [--oroot <fn=estimated>] : Estimated "
                           "corrections and gains (Ideal=Observed*Corr)")
        self.addParamsLine("  [--iter <N=3>] : Number of iterations")
        self.addParamsLine("  [--sigma <s=-1>] : Smoothing sigma; if "
                           "negative it is searched")
        self.addParamsLine("  [--maxSigma <s=3>] : Maximum number of "
                           "neighbour rows/columns to analyze")
        self.addParamsLine("  [--frameStep <s=1>] : Skip frames (1 = all, "
                           "2 = every other, ...)")
        self.addParamsLine("  [--sigmaStep <s=0.5>] : Step size for the "
                           "sigma search")
        self.addParamsLine("  [--singleRef] : Use a single histogram "
                           "reference (no contamination/carbon holes)")
        self.addParamsLine("  [--gainImage <fn=\"\">] : External gain "
                           "image (we will divide by it)")
        self.addParamsLine("  [--applyGain <fnOut=\"\">] : Write the "
                           "gain-corrected movie here (uses the external "
                           "gain image)")

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.oroot = self.getParam("--oroot")

    def run(self):
        device = resolve_device(self.getParam("--device"))
        with timed_phase("read movie"):
            frames = as_tensor(_load_movie(self.fn_in), device)
        gain0 = None
        if self.checkParam("--gainImage") and self.getParam("--gainImage"):
            gain0 = np.squeeze(Image(self.getParam("--gainImage")).data
                               ).astype(np.float64)
            if gain0.shape != tuple(frames.shape[1:]):
                raise ValueError("The gain image and the movie do not "
                                 "have the same dimensions")
        if self.checkParam("--applyGain") and self.getParam("--applyGain"):
            # correct the movie with the external gain (run(),
            # movie_estimate_gain.cpp:163-177)
            ig = as_tensor(gain0 if gain0 is not None
                           else np.ones(frames.shape[1:]), device,
                           torch.float64)
            save_image(self.getParam("--applyGain"),
                       _host((frames.to(torch.float64) / ig[None])
                             .to(torch.float32)))
            return
        with timed_phase("estimate gain"):
            gain = mops.estimate_gain_histogram(
                frames, n_iter=self.getIntParam("--iter"),
                sigma=self.getDoubleParam("--sigma"),
                max_sigma=self.getDoubleParam("--maxSigma"),
                sigma_step=self.getDoubleParam("--sigmaStep"),
                frame_step=self.getIntParam("--frameStep"),
                single_ref=self.checkParam("--singleRef"),
                gain0=gain0, verbose=self.verbose)
        save_image(self.oroot + "_gain.xmp", gain)
        # backward-compatible alias of the pre-surface output name
        save_image(self.oroot + ".xmp", gain)
        self.gain = gain


PROGRAM = None
