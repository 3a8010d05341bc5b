"""Spectral SNR estimation and continuous-assignment residual creation.

Contracts: reference resolution_ssnr.{h,cpp} (legacy/libraries/reconstruction;
SSNR 1D table, VSSNR volume, radial average of a VSSNR) and
continuous_create_residuals.{h,cpp} (projection-minus-image residual stacks
with per-image gray optimization, "shifting projection not image").

Counterpart of the reference package's programs/ssnr_residuals.py. All
projections of the signal/noise volumes come from one FourierProjector on the
card (--device; the card by default); the four power spectra are summed over
the images there, in float64, and the ring accumulation of each sum runs
once on the host (it is linear in the power, so this is the reference's
per-image accumulation summed). The VSSNR's trilinear scatter of the
per-image SSNR planes runs on the card with index_add_, in float64.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.programs.angular_programs import \
    ProgAngularContinuousAssign2 as _Assign2Base


def _ring_accumulate(power, ring_width, n_bins):
    """Reference ring accumulation (resolution_ssnr.cpp estimateSSNR ring
    loop): each full-FFT pixel with fx >= 0 adds into bins
    ceil(widx - ring_width) .. floor(widx). power: (H, W) full-FFT power.
    Returns (sums (n_bins,), counts (n_bins,))."""
    H, W = power.shape
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    keep = fx >= 0
    widx = np.sqrt(fx ** 2 + fy ** 2) * W
    sums = np.zeros(n_bins)
    counts = np.zeros(n_bins)
    l0 = np.maximum(np.ceil(widx - ring_width), 0).astype(int)
    lF = np.floor(widx).astype(int)
    p = np.where(keep, power, 0.0)
    k = np.where(keep, 1.0, 0.0)
    for d in range(int(ring_width) + 1):
        l = l0 + d
        valid = (l <= lF) & (l < n_bins) & keep
        lv = np.where(valid, l, 0)
        sums += np.bincount(lv.ravel(), weights=np.where(valid, p, 0.0).ravel(),
                            minlength=n_bins)
        counts += np.bincount(lv.ravel(),
                              weights=np.where(valid, k, 0.0).ravel(),
                              minlength=n_bins)
    return sums, counts


class ProgResolutionSSNR(XmippProgram):
    name = "xmipp_resolution_ssnr"

    def defineParams(self):
        self.addUsageLine("Evaluate reconstruction quality by the Spectral "
                          "Signal-to-Noise Ratio (SSNR) or its volumetric "
                          "distribution (VSSNR).")
        self.addParamsLine("  [--signal <signal_file>] : Signal volume")
        self.addParamsLine("     alias -S;")
        self.addParamsLine("  [--noise <noise_file>]   : Noise volume")
        self.addParamsLine("     alias -N;")
        self.addParamsLine("  [--sel_signal <md>]  : Images of the signal reconstruction")
        self.addParamsLine("     alias -selS;")
        self.addParamsLine("  [--sel_noise <md>]   : Images of the noise reconstruction")
        self.addParamsLine("     alias -selN;")
        self.addParamsLine("  [-o <file=\"\">]       : Output SSNR table")
        self.addParamsLine("  [--ring <w=4>]       : Ring width (Fourier px)")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size (A)")
        self.addParamsLine("     alias -s;")
        self.addParamsLine("  [--min_power <th=1e-10>] : Minimum power before SSNR is zeroed")
        self.addParamsLine("  [--gen_VSSNR]        : Generate the volumetric SSNR")
        self.addParamsLine("  [--VSSNR <fn_vol=VSSNR.vol>] : VSSNR volume file (output of --gen_VSSNR, input of --radial_avg)")
        self.addParamsLine("  [--radial_avg]       : Radial average of an existing VSSNR volume")
        self.addParamsLine("  [--sym <s=c1>]       : Symmetry for the VSSNR reconstruction")

    # images a projection and power pass takes at a time
    batch = 1024

    def _powers(self, projS, projN, imgsS, imgsN, rot, tilt, psi,
                keep_maps: bool):
        """Sums over the images of |FFT|^2 of the signal reprojections, the
        signal residuals, the noise reprojections and the noise residuals
        (float64, on the card); with keep_maps also the per-image 2-D SSNR
        planes of --gen_VSSNR (B, n, n), dB."""
        dev = projS.device
        sums = [0.0] * 4
        maps = []
        pw = lambda x: torch.fft.fft2(x).abs() ** 2
        for s in range(0, len(rot), self.batch):
            sl = slice(s, s + self.batch)
            # Iths/Ithn: reprojections at the metadata angles (reference
            # projectVolume semantics); residuals Is-Iths / In-Ithn
            Pths = projS.project_euler(rot[sl], tilt[sl], psi[sl])
            Pthn = projN.project_euler(rot[sl], tilt[sl], psi[sl])
            S2s = pw(Pths)
            N2s = pw(torch.as_tensor(imgsS[sl], device=dev) - Pths)
            S2n = pw(Pthn)
            N2n = pw(torch.as_tensor(imgsN[sl], device=dev) - Pthn)
            for j, P in enumerate((S2s, N2s, S2n, N2n)):
                sums[j] = sums[j] + P.double().sum(dim=0)
            if keep_maps:
                mp = self.min_power
                issnr = torch.where(N2s > mp, S2s / N2s, 0.0)
                alpha = torch.where(N2n > mp, S2n / N2n, 0.0)
                ssnr2d = torch.where(
                    alpha > mp,
                    torch.clamp(issnr / alpha.clamp(min=1e-30) - 1.0,
                                min=0.0), 0.0)
                maps.append(10.0 * torch.log10(ssnr2d + 1.0))
        return [x.cpu().numpy() for x in sums], maps

    def run(self):
        self.refuse_unread("--sym", item=13)
        self.ring = self.getDoubleParam("--ring")
        self.Ts = self.getDoubleParam("--sampling_rate")
        self.min_power = self.getDoubleParam("--min_power")

        if self.checkParam("--radial_avg"):
            self._radial_avg()
            return

        from xmipp3_tpu_torch.ops.project import FourierProjector
        dev = resolve_device(self.getParam("--device"))
        S = np.squeeze(Image(self.getParam("--signal")).data).astype(np.float32)
        N = np.squeeze(Image(self.getParam("--noise")).data).astype(np.float32)
        mdS = MetaData(self.getParam("--sel_signal"))
        mdN = MetaData(self.getParam("--sel_noise"))
        rowsS, rowsN = list(mdS.iterRows()), list(mdN.iterRows())
        with timed_phase("read images"):
            imgsS = load_image_rows(rowsS)
            imgsN = load_image_rows(rowsN)
        get = lambda rows, k: np.array([float(r.get(k, 0.0)) for r in rows],
                                       np.float32)
        rot, tilt, psi = (get(rowsS, k) for k in
                          ("angleRot", "angleTilt", "anglePsi"))
        gen_vssnr = self.checkParam("--gen_VSSNR")
        with timed_phase("powers"):
            sums, maps = self._powers(
                FourierProjector(S, device=dev), FourierProjector(N,
                                                                  device=dev),
                imgsS, imgsN, rot, tilt, psi, gen_vssnr)

        n = imgsS.shape[-1]
        n_bins = int(n / 2 - self.ring)
        acc = {}
        for key, P in zip(("S_S2", "S_N2", "N_S2", "N_N2"), sums):
            acc[key], c = _ring_accumulate(P, self.ring, n_bins)
        # per the reference: SSNR ratios use raw ring sums; the dB power
        # columns are count-normalized, by the ring counts summed over the
        # noise images (its accumulator of counts)
        eps = 1e-30
        S_SSNR = acc["S_S2"] / np.maximum(acc["S_N2"], eps)
        N_SSNR = acc["N_S2"] / np.maximum(acc["N_N2"], eps)
        nimg = len(imgsS)
        counts = np.maximum(c * len(imgsN), 1e-12)
        rows = []
        for i in range(n_bins):
            w = i / float(n)
            if w > 0.5:
                break
            ssnr = S_SSNR[i] / max(N_SSNR[i], eps)
            rows.append([i, w / self.Ts,
                         10 * np.log10(ssnr - 1) if ssnr > 1 else -1000.0,
                         S_SSNR[i],
                         10 * np.log10(acc["S_S2"][i] / counts[i] / nimg + eps),
                         10 * np.log10(acc["S_N2"][i] / counts[i] / nimg + eps),
                         N_SSNR[i],
                         10 * np.log10(acc["N_S2"][i] / counts[i] / nimg + eps),
                         10 * np.log10(acc["N_N2"][i] / counts[i] / nimg + eps)])
        fn_out = self.getParam("-o") if self.checkParam("-o") else ""
        if not fn_out:
            root, ext = os.path.splitext(self.getParam("--signal"))
            fn_out = root + "_SSNR.txt"
        self._write_table(fn_out, rows,
                          "index freq(1/A) SSNR(dB) S_SSNR S_S2(dB) S_N2(dB) "
                          "N_SSNR N_S2(dB) N_N2(dB)")
        self.ssnr_table = np.array(rows)

        if gen_vssnr:
            # per-image 2D SSNR maps live on central Fourier planes of the
            # volume; the VSSNR is their trilinear interpolation onto the 3D
            # Fourier grid (the reference approximates this with ART at
            # --ray_length 1 over the CenterFFT'd maps; here the slices are
            # scattered directly, which is the exact operation)
            with timed_phase("VSSNR"):
                vol = self._scatter_slices(torch.cat(maps), rot, tilt, psi)
            save_image(self.getParam("--VSSNR"), vol.astype(np.float32))
            if self.verbose:
                print(f"VSSNR -> {self.getParam('--VSSNR')}")

    @staticmethod
    def _scatter_slices(maps, rot, tilt, psi):
        """Trilinear scatter of per-projection Fourier-plane maps ((B, n, n)
        tensor, fft index order) into a centered 3D grid, averaged by the
        accumulated weight; float64 on the maps' device, 64 planes at a
        time, returned on the host."""
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        B, n, _ = maps.shape
        dev = maps.device
        f64 = torch.float64
        mats = torch.as_tensor(np.asarray(euler_matrix(rot, tilt, psi),
                                          np.float64), device=dev)
        f = torch.as_tensor(np.fft.fftfreq(n) * n, dtype=f64, device=dev)
        fy, fx = torch.meshgrid(f, f, indexing="ij")
        sums = torch.zeros(n * n * n, dtype=f64, device=dev)
        wsum = torch.zeros(n * n * n, dtype=f64, device=dev)
        half = n // 2
        for s in range(0, B, 64):
            m = mats[s:s + 64]
            p = (fx.reshape(1, -1, 1) * m[:, None, 0]
                 + fy.reshape(1, -1, 1) * m[:, None, 1] + half).reshape(-1, 3)
            v = maps[s:s + 64].reshape(-1).to(f64)
            p0 = torch.floor(p).to(torch.int64)
            fr = p - p0
            for dz in (0, 1):
                for dyy in (0, 1):
                    for dxx in (0, 1):
                        q = p0 + torch.tensor([dxx, dyy, dz], device=dev)
                        w = (torch.abs(1 - dxx - fr[:, 0])
                             * torch.abs(1 - dyy - fr[:, 1])
                             * torch.abs(1 - dz - fr[:, 2]))
                        ok = ((q >= 0) & (q < n)).all(dim=1)
                        w = torch.where(ok, w, 0.0)
                        q = q.clamp(0, n - 1)
                        idx = (q[:, 2] * n + q[:, 1]) * n + q[:, 0]
                        sums.index_add_(0, idx, w * v)
                        wsum.index_add_(0, idx, w)
        return (sums / wsum.clamp(min=1e-12)).reshape(n, n, n).cpu().numpy()

    def _radial_avg(self):
        """Radial average of 10*log10(VSSNR+1) (reference radialAverage)."""
        V = np.squeeze(Image(self.getParam("--VSSNR")).data).astype(np.float64)
        n = V.shape[-1]
        n_bins = int(n / 2 - self.ring)
        lin = np.power(10.0, np.fft.ifftshift(V) / 10.0) - 1.0
        f = [np.fft.fftfreq(s) for s in V.shape]
        w = np.sqrt(sum(np.meshgrid(*f, indexing="ij")[i] ** 2
                        for i in range(V.ndim)))
        keep = np.meshgrid(*f, indexing="ij")[-1] >= 0
        widx = w * n
        sums = np.zeros(n_bins)
        counts = np.zeros(n_bins)
        l0 = np.maximum(np.ceil(widx - self.ring), 0).astype(int)
        lF = np.floor(widx).astype(int)
        for d in range(int(self.ring) + 1):
            l = l0 + d
            valid = (l <= lF) & (l < n_bins) & keep
            lv = np.where(valid, l, 0)
            sums += np.bincount(lv.ravel(), minlength=n_bins,
                                weights=np.where(valid, lin, 0.0).ravel())
            counts += np.bincount(lv.ravel(), minlength=n_bins,
                                  weights=valid.ravel().astype(float))
        avg = sums / np.maximum(counts, 1e-12)
        rows = [[i, i / float(n) / self.Ts,
                 10 * np.log10(avg[i] - 1) if avg[i] > 1 else -1000.0]
                for i in range(n_bins)]
        fn_out = self.getParam("-o") if self.checkParam("-o") else \
            os.path.splitext(self.getParam("--VSSNR"))[0] + "_radial.txt"
        self._write_table(fn_out, rows, "index freq(1/A) SSNR(dB)")
        self.ssnr_table = np.array(rows)

    def _write_table(self, fn, rows, header):
        with open(fn, "w") as f:
            f.write(f"; {header}\n")
            for r in rows:
                f.write(" ".join(f"{v:12.6g}" for v in r) + "\n")
        if self.verbose:
            print(f"SSNR table -> {fn}")


class ProgContinuousCreateResiduals(_Assign2Base):
    """Create residual images (experimental minus continuously-refined
    reference projection). The reference grammar
    (continuous_create_residuals.cpp defineParams) is a strict subset of
    angular_continuous_assign2's — the engine and every optimize*/max_*
    flag are shared; this endpoint additionally tags each row with its
    MDL_IMAGE_RESIDUAL entry."""
    name = "xmipp_continuous_create_residuals"

    def run(self):
        super().run()
        fn_res = self.getParam("--oresiduals")
        if fn_res:
            md = MetaData(self.getParam("-o"))
            rows = list(md.iterRows())
            for i, r in enumerate(rows):
                r["imageResidual"] = f"{i + 1:06d}@{fn_res}"
            MetaData.fromRows(rows).write(self.getParam("-o"))
