"""xmipp_transform_filter — apply Fourier/wavelet/real-space filters, on the
card.

Contract: reference program_filter.{h,cpp} (the filter dispatch) +
data/fourier_filter.cpp, reconstruction/denoise.cpp (WaveletFilter),
data/filters.cpp (BadPixel/Background/Median/Diffusion/Basis/Log/
Retinex/DenoiseTV filters), reconstruction/mean_shift.cpp, with the flags
of the reference package's programs/transform_filter.py. The Fourier,
wavelet, TV, median, mean-shift, diffusion, basis, log and plane filters
run on the card; bad pixels, the rolling ball and retinex run on the host
in numpy, where the reference package runs them.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
from xmipp3_tpu_torch.ops.fourier_filter import FourierFilter


class ProgTransformFilter(XmippMetadataProgram):
    name = "xmipp_transform_filter"

    def defineProcessParams(self):
        self.addUsageLine("Filter images or volumes in Fourier or real space.")
        self.addParamsLine("== Fourier ==")
        self.addParamsLine("  [--fourier <filter_type>]    : Filter in Fourier space")
        self.addParamsLine("         where <filter_type>")
        self.addParamsLine("            low_pass  <w1> <raisedw=0.02>      : Cutoff freq (<1/2 or A)")
        self.addParamsLine("            high_pass <w1> <raisedw=0.02>      : Cutoff freq (<1/2 or A)")
        self.addParamsLine("            band_pass <w1> <w2> <raisedw=0.02> : Cutoff freq (<1/2 or A)")
        self.addParamsLine("            stop_band <w1> <w2> <raisedw=0.02> : Cutoff freq (<1/2 or A)")
        self.addParamsLine("            stop_lowbandx <w1> <raisedw=0.02>  : Cutoff freq (<1/2 or A)")
        self.addParamsLine("            stop_lowbandy <w1> <raisedw=0.02>  : Cutoff freq (<1/2 or A)")
        self.addParamsLine("            real_gaussian <w1>                 : Gaussian in real space, sigma=w1")
        self.addParamsLine("            gaussian <w1>                      : Gaussian in Fourier space, sigma=w1")
        self.addParamsLine("            sparsify <p=0.975>                 : Delete smallest Fourier coefficients")
        self.addParamsLine("            ctf <ctfile>                       : Provide a .ctfparam file")
        self.addParamsLine("            ctfpos <ctfile>                    : .ctfparam, phase corrected before applying")
        self.addParamsLine("            ctfinv <ctfile> <minCTF=0.05>      : Apply inverse of the CTF")
        self.addParamsLine("            ctfposinv <ctfile> <minCTF=0.05>   : Apply inverse of abs(CTF)")
        self.addParamsLine("            ctfdef <kV> <Cs> <Q0> <defocus>    : CTF from parameters")
        self.addParamsLine("            ctfdefastig <kV> <Cs> <Q0> <defocusU> <defocusV> <defocusAngle> : Astigmatic CTF")
        self.addParamsLine("            bfactor <B>                        : Exponential filter")
        self.addParamsLine("               requires --sampling;")
        self.addParamsLine("            fsc <metadata>                     : Filter with FSC profile")
        self.addParamsLine("               requires --sampling;")
        self.addParamsLine("            binary_file <file>                 : Binary file with the filter")
        self.addParamsLine("         alias -f;")
        self.addParamsLine("  [--sampling <sampling_rate>]   : Sampling rate (Å/pixel); pass frequencies in Å")
        self.addParamsLine("         alias -s;")
        self.addParamsLine("== Wavelet ==")
        self.addParamsLine("  [--wavelet <DWT_type=DAUB12> <mode=remove_scale>] : Wavelet-domain filters")
        self.addParamsLine("    where <DWT_type>")
        self.addParamsLine("       DAUB4 DAUB12 DAUB20 HAAR : Discrete Wavelet Transform bank")
        self.addParamsLine("    where <mode>")
        self.addParamsLine("       remove_scale")
        self.addParamsLine("       bayesian <SNR0=0.1> <SNRF=0.2> : Smallest(SNR0) and largest(SNRF) SNR")
        self.addParamsLine("       soft_thresholding")
        self.addParamsLine("       adaptive_soft")
        self.addParamsLine("       central")
        self.addParamsLine("    alias -w;")
        self.addParamsLine("  [--scale <s=0>]         : scale")
        self.addParamsLine("  [--output_scale <s=0>]  : output_scale")
        self.addParamsLine("  [--th <th=50>]          : threshold of values (%) to remove")
        self.addParamsLine("  [-R <r=-1>]             : Radius to keep, by default half the size")
        self.addParamsLine("  [--white_noise]         : Select if the noise is white (bayesian)")
        self.addParamsLine("  [--waveletThreshold <s=3>] : Soft threshold (noise sigmas; this framework's quick denoise)")
        self.addParamsLine("== Bad pixels ==")
        self.addParamsLine("  [--bad_pixels <type>]   : Repair bad pixels")
        self.addParamsLine("         where <type>")
        self.addParamsLine("            negative          : Repair negative values")
        self.addParamsLine("            mask <mask_file>  : Repair pixels given by mask")
        self.addParamsLine("            outliers <factor> : Repair pixels out of [mean +- factor*std]")
        self.addParamsLine("         alias -b;")
        self.addParamsLine("== Mean shift ==")
        self.addParamsLine("  [--mean_shift <hr> <hs> <iter=1>] : Mean-shift smoothing (range/spatial sigmas)")
        self.addParamsLine("         alias -t;")
        self.addParamsLine("  [--fast] : Use the faster box-window variant")
        self.addParamsLine("== Background removal ==")
        self.addParamsLine("  [--background <type=plane>] : Remove the image background")
        self.addParamsLine("         where <type>")
        self.addParamsLine("            plane                : Remove the best-fit plane")
        self.addParamsLine("            rollingball <radius> : Rolling-ball background")
        self.addParamsLine("         alias -g;")
        self.addParamsLine("== Median ==")
        self.addParamsLine("  [--median] : 3x3 median filter")
        self.addParamsLine("         alias -m;")
        self.addParamsLine("== Anisotropic diffusion ==")
        self.addParamsLine("  [--diffusion] : Mumford-Shah anisotropic diffusion")
        self.addParamsLine("  [--shah_iter <outer=10> <inner=1> <refinement=1>] : Diffusion iterations")
        self.addParamsLine("     requires --diffusion;")
        self.addParamsLine("  [--shah_weight <w0=0> <w1=50> <w2=50> <w3=0.02>] : Diffusion weights")
        self.addParamsLine("     requires --diffusion;")
        self.addParamsLine("  [--shah_only_edge] : Produce the edge image of the diffusion")
        self.addParamsLine("     requires --diffusion;")
        self.addParamsLine("== Basis filter ==")
        self.addParamsLine("  [--basis <file> <N=-1>] : Project onto the first N basis images")
        self.addParamsLine("== Log filter ==")
        self.addParamsLine("  [--log] : fa - fb*log(x + fc) (scanner preprocessing)")
        self.addParamsLine("  [--fa <a=4.431>] : log filter a")
        self.addParamsLine("  [--fb <b=0.4018>] : log filter b")
        self.addParamsLine("  [--fc <c=336.6>] : log filter c")
        self.addParamsLine("== Retinex ==")
        self.addParamsLine("  [--retinex <percentile=0.9> <mask_file=\"\"> <eps=1>] : Retinex Laplacian percentile filter")
        self.addParamsLine("== Total variation ==")
        self.addParamsLine("  [--denoiseTV] : TV denoising for micrographs")
        self.addParamsLine("  [--maxIterTV <maxIter=50>] : TV iterations")
        self.addParamsLine("  [--tv <weight=0.1> <iters=50>] : TV denoising with explicit weight")

    def readProcessParams(self):
        self.sampling = (self.getDoubleParam("--sampling")
                         if self.checkParam("--sampling") else None)
        self.mode = None
        self.filter = None
        if self.checkParam("--wavelet"):
            self.mode = "wavelet"
            self.wv_kind = self.getParam("--wavelet", 0)
            self.wv_mode = self.getParam("--wavelet", 1)
            toks = self.getListParam("--wavelet")
            self.wv_snr = (float(toks[2]) if len(toks) > 2 else 0.1,
                           float(toks[3]) if len(toks) > 3 else 0.2)
            self.wv_scale = self.getIntParam("--scale") \
                if self.checkParam("--scale") else 0
            self.wv_oscale = self.getIntParam("--output_scale") \
                if self.checkParam("--output_scale") else 0
            self.wv_th = self.getDoubleParam("--th") \
                if self.checkParam("--th") else 50.0
            self.wv_R = self.getIntParam("-R") \
                if self.checkParam("-R") else -1
            self.wv_white = self.checkParam("--white_noise")
            self.wv_sigmas = self.getDoubleParam("--waveletThreshold") \
                if self.checkParam("--waveletThreshold") else None
        elif self.checkParam("--bad_pixels"):
            self.mode = "bad_pixels"
            self.bp_type = self.getParam("--bad_pixels")
            if self.bp_type == "mask":
                from xmipp3_tpu_torch.core.image import load_image
                self.bp_mask = np.squeeze(
                    load_image(self.getParam("--bad_pixels", 1))) > 0.5
            elif self.bp_type == "outliers":
                self.bp_factor = self.getDoubleParam("--bad_pixels", 1)
        elif self.checkParam("--mean_shift"):
            self.mode = "mean_shift"
            self.ms = (self.getDoubleParam("--mean_shift", 0),
                       self.getDoubleParam("--mean_shift", 1),
                       self.getIntParam("--mean_shift", 2))
            self.ms_fast = self.checkParam("--fast")
        elif self.checkParam("--background"):
            self.mode = "background"
            self.bg_type = self.getParam("--background")
            self.bg_radius = (self.getIntParam("--background", 1)
                              if self.bg_type == "rollingball" else 0)
        elif self.checkParam("--median"):
            self.mode = "median"
        elif self.checkParam("--diffusion"):
            self.mode = "diffusion"
            self.shah_iter = ([self.getIntParam("--shah_iter", i)
                               for i in range(3)]
                              if self.checkParam("--shah_iter")
                              else [10, 1, 1])
            self.shah_w = ([self.getDoubleParam("--shah_weight", i)
                            for i in range(4)]
                           if self.checkParam("--shah_weight")
                           else [0.0, 50.0, 50.0, 0.02])
            self.shah_edge = self.checkParam("--shah_only_edge")
        elif self.checkParam("--basis"):
            self.mode = "basis"
            from xmipp3_tpu_torch.core.image import Image
            basis = Image.read_stack(self.getParam("--basis", 0))
            nb = self.getIntParam("--basis", 1)
            self.basis = basis[:nb] if nb > 0 else basis
        elif self.checkParam("--log"):
            self.mode = "log"
            self.log_abc = (
                self.getDoubleParam("--fa") if self.checkParam("--fa") else 4.431,
                self.getDoubleParam("--fb") if self.checkParam("--fb") else 0.4018,
                self.getDoubleParam("--fc") if self.checkParam("--fc") else 336.6)
        elif self.checkParam("--retinex"):
            self.mode = "retinex"
            toks = self.getListParam("--retinex")
            self.rx_pct = float(toks[0]) if toks else 0.9
            self.rx_mask = None
            if len(toks) > 1 and toks[1]:
                from xmipp3_tpu_torch.core.image import load_image
                self.rx_mask = np.squeeze(load_image(toks[1]))
            self.rx_eps = float(toks[2]) if len(toks) > 2 else 1.0
        elif self.checkParam("--denoiseTV"):
            self.mode = "tv"
            it = (self.getIntParam("--maxIterTV")
                  if self.checkParam("--maxIterTV") else 50)
            self.tv = (0.1, it)
        elif self.checkParam("--tv"):
            self.mode = "tv"
            self.tv = (self.getDoubleParam("--tv", 0),
                       self.getIntParam("--tv", 1))
        else:
            toks = self.getListParam("--fourier")
            if not toks:
                from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
                raise XmippError(ErrCode.ARG_MISSING,
                                 "You should provide some filter")
            self.mode = "fourier"
            self.filter = FourierFilter(toks[0], toks[1:],
                                        sampling=self.sampling)

    def preProcess(self):
        # full float32: no TF32 in library products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def processBatch(self, imgs, rows):
        m = self.mode
        if m in ("bad_pixels", "retinex") or (
                m == "background" and self.bg_type != "plane"):
            return self._host_filter(imgs)
        x = torch.as_tensor(imgs, device=self.device)
        if m == "fourier":
            return self.filter.apply(x)
        if m == "wavelet":
            from xmipp3_tpu_torch.ops import denoise
            if self.wv_kind.upper() == "HAAR":
                return denoise.wavelet_denoise_2d(x, self.wv_sigmas or 3.0)
            if self.wv_sigmas is not None:
                return denoise.db4_denoise_2d(x, self.wv_sigmas)
            return denoise.wavelet_filter_2d(
                x, self.wv_kind, self.wv_mode, scale=self.wv_scale,
                output_scale=self.wv_oscale, threshold_pct=self.wv_th,
                R=self.wv_R, snr0=self.wv_snr[0], snrf=self.wv_snr[1],
                white_noise=self.wv_white)
        from xmipp3_tpu_torch.ops import spatial_filters as sf
        if m == "mean_shift":
            hr, hs, iters = self.ms
            return sf.mean_shift_filter(x, hr, hs, iters, fast=self.ms_fast)
        if m == "background":
            from xmipp3_tpu_torch.ops.normalize import \
                subtract_background_plane
            full = np.ones(imgs.shape[-2:], np.float32)
            return subtract_background_plane(x, full)
        if m == "median":
            return sf.median_3x3(x)
        if m == "diffusion":
            out = []
            for i in x:
                fs, s = sf.smoothing_shah(i, self.shah_w, *self.shah_iter)
                out.append(s if self.shah_edge else fs)
            return torch.stack(out)
        if m == "basis":
            return sf.basis_filter(x, self.basis)
        if m == "log":
            a, b, c = self.log_abc
            return sf.log_filter(x, a, b, c)
        if m == "tv":
            from xmipp3_tpu_torch.ops.denoise import tv_denoise_2d
            return tv_denoise_2d(x, self.tv[0], int(self.tv[1]))
        raise AssertionError(m)

    def _host_filter(self, imgs):
        """The filters that run on the host, image by image, in numpy."""
        from xmipp3_tpu_torch.ops import spatial_filters as sf
        if self.mode == "retinex":
            one = lambda i: sf.retinex_filter(i, self.rx_pct, self.rx_mask,
                                              self.rx_eps)
        elif self.mode == "background":
            one = lambda i: sf.rolling_ball_background(i, self.bg_radius)
        elif self.bp_type == "negative":
            one = sf.force_positive
        elif self.bp_type == "mask":
            one = lambda i: sf.bound_median_filter(i, self.bp_mask)
        else:
            one = lambda i: sf.pixel_desv_filter(i, self.bp_factor)
        return np.stack([one(i) for i in imgs])


PROGRAM = ProgTransformFilter
