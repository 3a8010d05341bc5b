"""Resolution and map post-processing programs: resolution_monogenic_signal
(MonoRes), resolution_monotomo, resolution_fso, resolution_localfilter,
volume_correct_bfactor and volume_structure_factor.

Counterpart of the reference package's programs/resolution_misc.py
(reference resolution_monogenic_signal.h:49, resolution_fso.h:38,
resolution_localfilter, resolution_monotomo.h:46, volume_correct_bfactor,
volume_structure_factor). The maps go to the card unless `--device cpu`
is given; the band loops, cone sums and radial profiles run there, and
the small fits and metadata stay on the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.ops.fourier import freq_grid_3d
from xmipp3_tpu_torch.ops.mask import circular_mask
from xmipp3_tpu_torch.ops.monogenic import (freq_radius_3d,
                                            fso_directional,
                                            local_resolution_monores)


def _volume(fn) -> np.ndarray:
    return np.squeeze(Image(fn).data).astype(np.float32)


def _masked_resolution(res_map, mask, sampling, fn_out):
    """Zero the map outside the mask, write it; return the masked values."""
    res = np.where(mask, res_map.cpu().numpy(), 0.0).astype(np.float32)
    save_image(fn_out, res, sampling=sampling)
    return res[mask]


def _shell_power(vol, sampling: float):
    """The rfftn of a volume on its device, the (D,H,W//2+1) frequency
    radius in 1/A (float32, host grids as the reference builds them), the
    D//2 shells of the radius and the shells' mean power |F|^2 (float64)."""
    D = vol.shape[0]
    F = torch.fft.rfftn(vol)
    fz, fy, fx = freq_grid_3d(*vol.shape)
    r = np.sqrt(fz ** 2 + fy ** 2 + fx ** 2) / sampling       # 1/A
    nbins = D // 2
    bins = np.minimum((r * sampling / 0.5 * nbins).astype(np.int32),
                      nbins - 1)
    idx = torch.as_tensor(bins.ravel(), dtype=torch.int64, device=vol.device)
    amp2 = (F.abs() ** 2).reshape(-1).to(torch.float64)
    radial = torch.zeros(nbins, dtype=torch.float64,
                         device=vol.device).index_add_(0, idx, amp2)
    counts = np.bincount(bins.ravel(), minlength=nbins)
    radial = radial.cpu().numpy() / np.maximum(counts, 1)
    return F, torch.as_tensor(r, device=vol.device), radial


class ProgMonoRes(XmippProgram):
    name = "xmipp_resolution_monogenic_signal"

    def defineParams(self):
        self.addUsageLine("Local resolution by monogenic-amplitude "
                          "hypothesis testing (MonoRes).")
        self.addParamsLine("   --vol <volume>   : Input map (or half map 1)")
        self.addParamsLine("  [--vol2 <volume=\"\">] : Half map 2 (averaged with 1)")
        self.addParamsLine("  [--mask <mask=\"\">]  : Binary mask of the particle")
        self.addParamsLine("  [-o <output=monores.vol>] : Local resolution map")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size (A)")
        self.addParamsLine("  [--minRes <r=-1>]  : Lowest tested resolution (A)")
        self.addParamsLine("  [--maxRes <r=-1>]  : Highest tested resolution (A)")
        self.addParamsLine("  [--significance <s=0.95>] : Noise percentile")
        self.addParamsLine("  [--steps <n=30>]   : Number of frequency bands")
        self.addParamsLine("  [--step <s=-1>]    : Resolution sweep step (A); "
                           "overrides --steps when positive")
        self.addParamsLine("  [--maskExcl <mask=\"\">] : Exclude this region "
                           "from the noise estimation")
        self.addParamsLine("  [--noiseonlyinhalves] : With two half maps, "
                           "estimate the noise inside the mask only")
        self.addParamsLine("  [--gaussian]       : Gaussian noise model "
                           "(mean + z*std threshold) instead of the exact "
                           "empirical distribution")

    def readParams(self):
        opt = lambda flag: self.getParam(flag) if self.checkParam(flag) \
            else ""
        self.fn_vol = self.getParam("--vol")
        self.fn_vol2 = opt("--vol2")
        self.fn_mask = opt("--mask")
        self.fn_mask_excl = opt("--maskExcl")
        self.fn_out = self.getParam("-o")
        self.Ts = self.getDoubleParam("--sampling_rate")
        self.min_res = self.getDoubleParam("--minRes")
        self.max_res = self.getDoubleParam("--maxRes")
        self.significance = self.getDoubleParam("--significance")
        self.steps = self.getIntParam("--steps")
        self.step = self.getDoubleParam("--step") \
            if self.checkParam("--step") else -1.0
        self.noise_in_halves = self.checkParam("--noiseonlyinhalves")
        self.gaussian = self.checkParam("--gaussian")

    def run(self):
        device = resolve_device(self.getParam("--device"))
        vol = _volume(self.fn_vol)
        noise_vol = None
        if self.fn_vol2:
            v2 = _volume(self.fn_vol2)
            # half-map mode: signal = mean, noise = half-difference
            # (resolution_monogenic_signal.cpp produceSideInfo)
            noise_vol = 0.5 * (vol - v2)
            vol = 0.5 * (vol + v2)
        if self.fn_mask:
            mask = np.squeeze(Image(self.fn_mask).data) > 0.5
        else:
            mask = circular_mask(vol.shape, vol.shape[0] // 2 - 4) > 0.5
        mask_excl = (np.squeeze(Image(self.fn_mask_excl).data) > 0.5) \
            if self.fn_mask_excl else None
        with timed_phase("monores"):
            res_map, freqs, frac = local_resolution_monores(
                vol, mask, self.Ts,
                None if self.min_res <= 0 else self.min_res,
                None if self.max_res <= 0 else self.max_res,
                n_freqs=self.steps, significance=self.significance,
                noise_vol=noise_vol, mask_excl=mask_excl,
                noise_only_in_halves=self.noise_in_halves,
                gaussian=self.gaussian,
                step=self.step if self.step > 0 else None, device=device)
        vals = _masked_resolution(res_map, mask, self.Ts, self.fn_out)
        self.median_resolution = float(np.median(vals))
        if self.verbose:
            print(f"Median local resolution: {self.median_resolution:.2f} A "
                  f"(min {vals.min():.2f}, max {vals.max():.2f})")


class ProgMonoTomo(XmippProgram):
    """Local resolution for tomograms (reference tomo/resolution_monotomo
    .cpp:59-69): the signal is the half-tomogram mean (--meanVol when
    provided), the noise the half-difference, swept over resolutions with
    --step (A); the same monogenic band engine as MonoRes."""
    name = "xmipp_resolution_monotomo"

    def defineParams(self):
        self.addUsageLine("Local resolution of a tomogram from two half "
                          "tomograms (MonoTomo).")
        self.addParamsLine("   --vol <half1>   : Half volume 1")
        self.addParamsLine("   --vol2 <half2>  : Half volume 2")
        self.addParamsLine("  [--meanVol <vol=\"\">] : Mean volume of the "
                           "halves (computed when not provided)")
        self.addParamsLine("  [-o <output=MGresolution.vol>] : Local "
                           "resolution volume (A)")
        self.addParamsLine("  [--mask <mask=\"\">]  : Binary mask")
        self.addParamsLine("  [--sampling_rate <s=1>] : Sampling rate (A/px)")
        self.addParamsLine("  [--step <s=0.25>] : Resolution sweep step (A)")
        self.addParamsLine("  [--minRes <s=30>] : Minimum resolution (A)")
        self.addParamsLine("  [--maxRes <s=1>]  : Maximum resolution (A)")
        self.addParamsLine("  [--significance <s=0.95>] : Confidence level "
                           "for the hypothesis test")

    def run(self):
        device = resolve_device(self.getParam("--device"))
        v1 = _volume(self.getParam("--vol"))
        v2 = _volume(self.getParam("--vol2"))
        Ts = self.getDoubleParam("--sampling_rate")
        if self.checkParam("--meanVol") and self.getParam("--meanVol"):
            vol = _volume(self.getParam("--meanVol"))
        else:
            vol = 0.5 * (v1 + v2)
        noise_vol = 0.5 * (v1 - v2)
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data) > 0.5
        else:
            mask = np.ones(vol.shape, bool)
        min_res = self.getDoubleParam("--minRes")
        max_res = self.getDoubleParam("--maxRes")
        step = self.getDoubleParam("--step")
        with timed_phase("monotomo"):
            res_map, freqs, frac = local_resolution_monores(
                vol, mask, Ts,
                None if min_res <= 0 else min_res,
                None if max_res <= 0 else max_res,
                significance=self.getDoubleParam("--significance"),
                noise_vol=noise_vol, noise_only_in_halves=True,
                step=step if step > 0 else None, device=device)
        vals = _masked_resolution(res_map, mask, Ts, self.getParam("-o"))
        self.median_resolution = float(np.median(vals))
        if self.verbose:
            print(f"Median local resolution: "
                  f"{self.median_resolution:.2f} A")


class ProgFSO(XmippProgram):
    name = "xmipp_resolution_fso"

    def defineParams(self):
        self.addUsageLine("Fourier Shell Occupancy: directional resolution "
                          "anisotropy from two half maps.")
        self.addParamsLine("   --half1 <v1>    : Half map 1")
        self.addParamsLine("   --half2 <v2>    : Half map 2")
        self.addParamsLine("  [-o <out_md=fso.xmd>] : FSO curve metadata")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size")
        self.addParamsLine("  [--mask <mask=\"\">] : Smooth mask applied to "
                           "both halves before the directional FSC")
        self.addParamsLine("  [--anglecone <a=20>] : Cone half angle (deg)")
        self.addParamsLine("  [--threshold <t=0.143>] : FSC threshold")
        self.addParamsLine("  [--threedfsc_filter] : Estimate the 3DFSC and "
                           "apply it as an anisotropic low-pass filter "
                           "(writes 3dFSC.mrc + filteredMap.mrc)")

    def readParams(self):
        self.fn1 = self.getParam("--half1")
        self.fn2 = self.getParam("--half2")
        self.fn_mask = self.getParam("--mask") \
            if self.checkParam("--mask") else ""
        self.fn_out = self.getParam("-o")
        self.Ts = self.getDoubleParam("--sampling")
        self.cone = self.getDoubleParam("--anglecone")
        self.threshold = self.getDoubleParam("--threshold")
        self.do_3dfsc = self.checkParam("--threedfsc_filter")

    def run(self):
        device = resolve_device(self.getParam("--device"))
        v1 = as_tensor(_volume(self.fn1), device)
        v2 = as_tensor(_volume(self.fn2), device)
        if self.fn_mask:
            m = as_tensor(_volume(self.fn_mask), device)
            v1 = v1 * m
            v2 = v2 * m
        with timed_phase("fso"):
            out = fso_directional(v1, v2, self.Ts, cone_deg=self.cone,
                                  threshold=self.threshold,
                                  compute_3dfsc=self.do_3dfsc)
        freqs, fso = out[:2]
        if self.do_3dfsc:
            odir = os.path.dirname(self.fn_out) or "."
            save_image(os.path.join(odir, "3dFSC.mrc"),
                       out[2].cpu().numpy(), sampling=self.Ts)
            save_image(os.path.join(odir, "filteredMap.mrc"),
                       out[3].cpu().numpy(), sampling=self.Ts)
        MetaData.fromRows([
            {"resolutionFreq": float(f / self.Ts), "resolutionFRC": float(o),
             "resolutionFreqReal": float(self.Ts / f) if f > 0 else 1e6}
            for f, o in zip(freqs, fso)]).write(self.fn_out)
        # global anisotropy summary: freq where FSO crosses 0.9, 0.5, 0.1
        self.fso = fso
        if self.verbose:
            for t in (0.9, 0.5, 0.1):
                below = np.where(fso < t)[0]
                if len(below) and below[0] > 0:
                    print(f"FSO {t:.1f} at "
                          f"{self.Ts / freqs[below[0]]:.2f} A")


class ProgResolutionLocalFilter(XmippProgram):
    """Full reference surface (resolution_localfilter.cpp:47-54,207-288):
    cosine-apodized boundaries, per-frequency raised-cosine bands between
    sampling/maxRes and sampling/minRes of the resolution map, per-voxel
    Gaussian weights exp(-(f_vox-f)^2/std) from the local resolution map,
    accumulated band by band on the device. As in the reference package,
    the accumulated band sum is normalized by the weight sum, and
    --significance is accepted for CLI parity (the hypothesis test lives
    in MonoRes)."""
    name = "xmipp_resolution_localfilter"

    def defineParams(self):
        self.addUsageLine("Filter a map locally according to a local "
                          "resolution map.")
        self.addParamsLine("   --vol <volume>  : Map to filter")
        self.addParamsLine("   --resvol <res>  : Local resolution map (A)")
        self.addParamsLine("  [-o <out=filtered.vol>] : Output")
        self.addParamsLine("  [--filteredMap <out=\"\">] : Extra copy of "
                           "the filtered map")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size")
        self.addParamsLine("  [--sampling_rate <s=-1>] : Pixel size "
                           "(reference spelling; overrides --sampling)")
        self.addParamsLine("  [--step <s=0.25>] : Resolution sweep step (A); "
                           "<=0 sweeps every Fourier index like the "
                           "reference")
        self.addParamsLine("  [--significance <s=0.95>] : Accepted for "
                           "reference parity (unused by the filter)")

    def readParams(self):
        self.fn_vol = self.getParam("--vol")
        self.fn_res = self.getParam("--resvol")
        self.fn_out = self.getParam("-o")
        self.fn_filtered = self.getParam("--filteredMap") \
            if self.checkParam("--filteredMap") else ""
        self.Ts = self.getDoubleParam("--sampling")
        if self.checkParam("--sampling_rate") and \
                self.getDoubleParam("--sampling_rate") > 0:
            self.Ts = self.getDoubleParam("--sampling_rate")
        self.step = self.getDoubleParam("--step") \
            if self.checkParam("--step") else 0.25

    def run(self):
        device = resolve_device(self.getParam("--device"))
        vol = _volume(self.fn_vol)
        res = _volume(self.fn_res)
        res = np.where(res <= 0, res[res > 0].max() if (res > 0).any()
                       else 2 * self.Ts, res)
        D, H, W = vol.shape
        min_res = float(res.max())
        max_res = float(max(res.min(), 2.0 * self.Ts))
        f_lo = self.Ts / min_res
        f_hi = min(self.Ts / max_res, 0.5)
        if self.step > 0:
            res_list = np.arange(min_res, max_res, -self.step)
            freqs = np.unique(np.clip(self.Ts / np.maximum(res_list, 1e-6),
                                      f_lo, f_hi)).astype(np.float32)
        else:
            lo_idx = max(int(round(f_lo * D)), 1)
            hi_idx = max(int(round(f_hi * D)), lo_idx + 1)
            freqs = (np.arange(lo_idx, hi_idx) / D).astype(np.float32)
        if len(freqs) == 0:
            freqs = np.asarray([f_hi], np.float32)

        # apodize boundaries with the reference's 10-voxel raised cosine
        n_s = 10
        apo = np.ones(vol.shape, np.float32)
        for ax, n in enumerate(vol.shape):
            u = np.abs(np.arange(n) - n // 2)
            lim = n // 2 - n_s
            a = np.where(u >= lim,
                         0.5 * (1 + np.cos(np.pi * (lim - u) / n_s)),
                         1.0).astype(np.float32)
            shape = [1, 1, 1]
            shape[ax] = n
            apo = apo * a.reshape(shape)
        volw = vol * apo

        fvox = (self.Ts / res).astype(np.float32)   # per-voxel digital freq
        std = np.float32(max(fvox.std(), 1e-3))
        with timed_phase("local filter"):
            out = _localfilter_sweep(as_tensor(volw, device),
                                     as_tensor(fvox, device), freqs, std)
        out = out.cpu().numpy()
        save_image(self.fn_out, out, sampling=self.Ts)
        if self.fn_filtered:
            save_image(self.fn_filtered, out, sampling=self.Ts)


def _localfilter_sweep(vol, fvox, freqs, std):
    """Sum over the bands of the raised-cosine band-passed map weighted per
    voxel by exp(-(fvox - f)^2 / (2 std^2)), normalised by the weights'
    sum; one band at a time on the map's device."""
    D, H, W = vol.shape
    dev = vol.device
    F = torch.fft.rfftn(vol)
    un = freq_radius_3d(D, H, W, dev)[0]
    std = torch.tensor(std, dtype=torch.float32, device=dev)
    acc = torch.zeros((D, H, W), dtype=torch.float32, device=dev)
    wsum = torch.zeros_like(acc)
    for f in torch.as_tensor(freqs, device=dev):
        f_l = torch.clamp(f - 0.02, min=0.001)
        f_h = torch.clamp(f + 0.02, max=0.5)
        hi = torch.where((un >= f) & (un <= f_h),
                         0.5 * (1 + torch.cos(torch.pi * (un - f) /
                                              torch.clamp(f_h - f,
                                                          min=1e-6))), 0.0)
        lo = torch.where((un >= f_l) & (un < f),
                         0.5 * (1 + torch.cos(torch.pi * (un - f) /
                                              torch.clamp(f - f_l,
                                                          min=1e-6))), 0.0)
        band = torch.fft.irfftn(F * (hi + lo), s=(D, H, W))
        w = torch.exp(-(fvox - f) ** 2 / (2.0 * std * std))
        acc += w * band
        wsum += w
    return acc / torch.clamp(wsum, min=1e-6)


class ProgVolumeCorrectBfactor(XmippProgram):
    name = "xmipp_volume_correct_bfactor"

    def defineParams(self):
        self.addUsageLine("Sharpen a map by automatic B-factor correction "
                          "(Guinier-plot fit, Rosenthal & Henderson).")
        self.addParamsLine("   -i <volume>     : Input map")
        self.addParamsLine("  [-o <out=\"\">]    : Output (default: overwrite)")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size")
        self.addParamsLine("  [--auto]        : Automatic B-factor from Guinier fit")
        self.addParamsLine("  [--adhoc <B=0>] : Apply this B-factor (A^2, negative sharpens)")
        self.addParamsLine("  [--maxres <r=-1>] : Max resolution for fit/application (A)")
        self.addParamsLine("  [--fit_minres <r=15>] : Min resolution of Guinier fit (A)")
        self.addParamsLine("  [--fit_maxres <r=-1>] : Max resolution of "
                           "Guinier fit (A); -1 uses --maxres")
        self.addParamsLine("  [--fsc <fscFile=\"\">] : FSC metadata from "
                           "xmipp_resolution_fsc; applies per-shell "
                           "sqrt(2FSC/(1+FSC)) SNR weights")

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.fn_out = self.getParam("-o") if self.checkParam("-o") else self.fn_in
        self.Ts = self.getDoubleParam("--sampling")
        self.auto = self.checkParam("--auto") or not self.checkParam("--adhoc")
        self.B = self.getDoubleParam("--adhoc") if self.checkParam("--adhoc") else 0.0
        self.maxres = self.getDoubleParam("--maxres")
        self.fit_minres = self.getDoubleParam("--fit_minres")
        self.fit_maxres = self.getDoubleParam("--fit_maxres") \
            if self.checkParam("--fit_maxres") else -1.0
        self.fn_fsc = self.getParam("--fsc") \
            if self.checkParam("--fsc") else ""

    def run(self):
        device = resolve_device(self.getParam("--device"))
        vol = as_tensor(_volume(self.fn_in), device)
        D = vol.shape[0]
        with timed_phase("radial power"):
            F, r, radial = _shell_power(vol, self.Ts)
        nbins = D // 2
        freqs = ((np.arange(nbins) + 0.5) * (0.5 / nbins)) / self.Ts
        if self.auto:
            maxres = self.fit_maxres if self.fit_maxres > 0 else (
                self.maxres if self.maxres > 0 else 2.2 * self.Ts)
            sel = (freqs > 1.0 / self.fit_minres) & (freqs < 1.0 / maxres) & \
                (radial > 0)
            if sel.sum() >= 3:
                x = freqs[sel] ** 2
                y = 0.5 * np.log(radial[sel])    # ln|F| = ln sqrt(P)
                slope, icept = np.polyfit(x, y, 1)
                self.B = 4.0 * slope             # ln|F| = c - (B/4) f^2
            else:
                self.B = 0.0
        maxres = self.maxres if self.maxres > 0 else 2.0 * self.Ts
        with timed_phase("apply"):
            inside = r <= 1.0 / maxres
            corr = torch.where(inside, torch.exp(-(self.B / 4.0) * r ** 2),
                               0.0)
            if self.fn_fsc:
                # per-shell SNR weights sqrt(2FSC/(1+FSC)) inside the
                # applied band (volume_correct_bfactor.cpp get_snr_weights/
                # apply_snr_weights)
                md_fsc = MetaData(self.fn_fsc)
                fsc = np.clip(np.asarray(
                    md_fsc.df["resolutionFRC"].values, np.float64), 0.0, 1.0)
                snr = torch.as_tensor(np.sqrt(np.maximum(
                    2.0 * fsc / (1.0 + fsc), 0.0)), device=device)
                idx = torch.clamp(torch.round(r * self.Ts * D).to(
                    torch.int64), max=len(snr) - 1)
                corr = corr * torch.where(inside, snr[idx], 1.0)
            out = torch.fft.irfftn(F * corr, s=vol.shape).to(torch.float32)
        save_image(self.fn_out, out.cpu().numpy(), sampling=self.Ts)
        if self.verbose:
            print(f"Applied B-factor: {self.B:.1f} A^2")


class ProgVolumeStructureFactor(XmippProgram):
    name = "xmipp_volume_structure_factor"

    def defineParams(self):
        self.addUsageLine("Radial structure factor (rotationally averaged "
                          "power spectrum) of a volume.")
        self.addParamsLine("   -i <volume>  : Input map")
        self.addParamsLine("  [-o <out=structureFactor.xmd>] : Output metadata")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size")

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.fn_out = self.getParam("-o")
        self.Ts = self.getDoubleParam("--sampling")

    def run(self):
        device = resolve_device(self.getParam("--device"))
        vol = as_tensor(_volume(self.fn_in), device)
        D = vol.shape[0]
        with timed_phase("radial power"):
            _, _, radial = _shell_power(vol, 1.0)
        nbins = D // 2
        freqs = (np.arange(nbins) + 0.5) * (0.5 / nbins)
        MetaData.fromRows([
            {"resolutionFreq": float(f / self.Ts),
             "resolutionFreqReal": float(self.Ts / f),
             "logStructureFactor": float(np.log(max(p, 1e-30)))}
            for f, p in zip(freqs, radial)]).write(self.fn_out)


PROGRAM = None
