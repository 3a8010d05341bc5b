"""Programs of the reference package's programs/resolution_dir.py:
xmipp_resolution_directional (MonoDir: the monogenic local resolution per
cone direction, every direction's bands batched on the card),
xmipp_ctf_estimate_psd_with_arma (the 2-D causal ARMA spectral model, host
float64 as in the reference) and xmipp_psd_estimate (averaged overlapping
periodograms, the patches transformed on the card),
xmipp_classify_CL2D_core_analysis (the PCA-outlier cores and the stable
cores of a CL2D hierarchy) and xmipp_angular_accuracy_pca (the PCA residual
score of each particle against its reprojection). Each runs on the card
unless `--device cpu` is given.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device

# voxels x bands (or directions) of one block of the directional work: all
# twelve bands of a 256^3 map at once (about 7 GB of transforms)
DIR_BLOCK = 1 << 28


def _hemisphere_directions(n: int) -> np.ndarray:
    """n roughly-uniform unit directions on the upper hemisphere
    (Fibonacci spiral; the reference package's design for the reference's
    hand-tabulated 81/47-direction set, resolution_directional.cpp:207,292)."""
    k = np.arange(n) + 0.5
    z = k / n                       # cos(tilt) in (0, 1] - upper hemisphere
    phi = np.pi * (1 + 5 ** 0.5) * k
    s = np.sqrt(np.clip(1 - z * z, 0, None))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)


def _direction_resolution(F, cone, bands, res_vals, mask, noise_idx,
                          significance):
    """One direction's resolution map: each band of the cone filtered out
    of F (rfftn, complex64) and transformed back, the monogenic amplitude
    of every band (batched), the significance percentile of each band's
    noise amplitudes, and the reference's sequential "still resolved"
    walk from the lowest band up. Returns a float32 map (0 outside the
    mask). The band's image is made, as in the reference, before its
    amplitude: in a band of one or two Fourier pairs the amplitude is
    nearly constant in space and the roundoff of that path decides the
    hypothesis test."""
    from xmipp3_tpu_torch.ops.monogenic import (monogenic_amplitude_3d,
                                                percentile_linear)
    shape = mask.shape
    nvox = mask.numel()
    res_map = torch.full(shape, float(res_vals[0]), dtype=torch.float32,
                         device=F.device)
    prev = mask
    step = max(1, DIR_BLOCK // nvox)
    for k0 in range(0, len(bands), step):
        amp = monogenic_amplitude_3d(torch.fft.irfftn(
            F * bands[k0:k0 + step] * cone, s=shape, dim=(-3, -2, -1)))
        thr = percentile_linear(amp.reshape(len(amp), -1)[:, noise_idx],
                                [100 * significance])[:, 0]
        for j in range(len(amp)):
            resolved = mask & (amp[j].to(torch.float64) > thr[j]) & prev
            res_map = torch.where(resolved, float(res_vals[k0 + j]),
                                  res_map)
            prev = resolved
    return torch.where(mask, res_map, 0.0)


def _shell_means(maps, shell, sel, n_shells):
    """Per shell s, the mean of each map over the voxels of `sel` in shell
    s: (len(maps), n_shells) float64, and the shells' voxel counts."""
    idx = shell[sel]
    cnt = torch.zeros(n_shells, dtype=torch.float64,
                      device=shell.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.float64))
    sums = torch.zeros((len(maps), n_shells), dtype=torch.float64,
                       device=shell.device)
    for i, m in enumerate(maps):
        sums[i].index_add_(0, idx, m[sel].to(torch.float64))
    return sums / cnt.clamp(min=1), cnt


class ProgResolutionDirectional(XmippProgram):
    name = "xmipp_resolution_directional"

    def defineParams(self):
        self.addUsageLine("Directional local resolution (MonoDir): monogenic "
                          "local resolution per cone direction; outputs "
                          "radial/azimuthal/anisotropy maps (full reference "
                          "surface, resolution_directional.cpp:64-83).")
        self.addParamsLine("   --vol <volume> : Input map")
        self.addParamsLine("  [--mask <m=\"\">] : Binary mask")
        self.addParamsLine("  [--oroot <root=monodir>] : Output rootname "
                           "(default names for any map not given explicitly)")
        self.addParamsLine("  [-o <out=\"\">] : Local (mean-over-directions) "
                           "resolution volume")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size")
        self.addParamsLine("  [--resStep <s=0.5>] : Resolution step (A)")
        self.addParamsLine("  [--volumeRadius <r=100>] : Particle radius "
                           "(px); noise is estimated outside it")
        self.addParamsLine("  [--significance <s=0.95>] : Confidence level "
                           "of the amplitude hypothesis test")
        self.addParamsLine("  [--ndirections <n=-1>] : Cone directions "
                           "(-1 = reference defaults: 81, 47 with --fast)")
        self.addParamsLine("  [--cone <a=45>] : Cone half angle (deg)")
        self.addParamsLine("  [--steps <n=12>] : Max frequency bands (cap)")
        self.addParamsLine("  [--fast] : Fast computation (fewer directions)")
        self.addParamsLine("  [--radialRes <f=\"\">] : Output radial "
                           "resolution map (directions within 45 deg of the "
                           "voxel radius vector)")
        self.addParamsLine("  [--azimuthalRes <f=\"\">] : Output azimuthal "
                           "resolution map (directions beyond 70 deg)")
        self.addParamsLine("  [--highestResolutionVol <f=\"\">] : Output "
                           "highest-resolution (5th percentile) map")
        self.addParamsLine("  [--lowestResolutionVol <f=\"\">] : Output "
                           "lowest-resolution (95th percentile) map")
        self.addParamsLine("  [--doa1 <f=\"\">] : Output anisotropy map "
                           "0.5*(p83-p17) over directions")
        self.addParamsLine("  [--doa2 <f=\"\">] : Output mean-extremes map "
                           "0.5*(p95+p05)")
        self.addParamsLine("  [--radialAzimuthalThresholds <f=\"\">] : "
                           "Metadata with the 90th-percentile radial and "
                           "azimuthal resolutions")
        self.addParamsLine("  [--radialAvG <f=\"\">] : Metadata with radial "
                           "averages of the five resolution maps")
        self.addParamsLine("  [--monores <f=\"\">] : Local resolution map "
                           "(MonoRes output) used for the radial average "
                           "and z-score (default: mean over directions)")
        self.addParamsLine("  [--prefMin <f=\"\">] : Metadata histogram of "
                           "the preferred (highest-resolution) direction")
        self.addParamsLine("  [--zScoremap <f=\"\">] : Local resolution "
                           "z-score map (|z|>3 = suspicious voxels)")
        self.addParamsLine("  [--threads <n=4>] : Accepted (device-managed)")

    def _opt(self, flag):
        return self.getParam(flag) if self.checkParam(flag) else ""

    def _out(self, flag, default):
        return self._opt(flag) or default

    def run(self):
        from xmipp3_tpu_torch.ops.fourier import freq_grid_3d
        from xmipp3_tpu_torch.ops.mask import circular_mask
        from xmipp3_tpu_torch.ops.monogenic import percentile_linear
        dev = resolve_device(self.getParam("--device"))
        vol = np.squeeze(Image(self.getParam("--vol")).data).astype(
            np.float32)
        Ts = self.getDoubleParam("--sampling_rate")
        D = vol.shape[0]
        if self._opt("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data) > 0.5
        else:
            mask = circular_mask(vol.shape, D // 2 - 4) > 0.5
        n_dirs = self.getIntParam("--ndirections")
        if n_dirs <= 0:
            n_dirs = 47 if self.checkParam("--fast") else 81
        cone = np.deg2rad(self.getDoubleParam("--cone"))
        significance = self.getDoubleParam("--significance")
        r_part = min(self.getDoubleParam("--volumeRadius"), D / 2 - 1)
        # resolution sweep: maxRes = box size (A) down to 2*Ts in resStep
        # steps (reference resolution_directional.cpp:105-106), capped at
        # --steps bands
        res_step = max(self.getDoubleParam("--resStep"), 1e-3)
        res_vals = np.arange(2 * Ts, D * Ts, res_step)[::-1]
        n_cap = self.getIntParam("--steps")
        if len(res_vals) > n_cap:
            res_vals = res_vals[np.linspace(0, len(res_vals) - 1, n_cap
                                            ).astype(int)]
        freqs = Ts / res_vals                    # ascending digital freq
        fz, fy, fx = freq_grid_3d(*vol.shape)
        r = np.sqrt(fz ** 2 + fy ** 2 + fx ** 2)
        rr = np.where(r == 0, 1.0, r)
        dirs = _hemisphere_directions(n_dirs)
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        # noise region: outside the mask and beyond the particle radius
        # (the voxel grid's float64 geometry as numpy computes it)
        zz, yy, xx = (torch.arange(n, dtype=torch.float64, device=dev)
                      - n / 2 for n in vol.shape)
        zz, yy, xx = zz[:, None, None], yy[None, :, None], xx[None, None, :]
        rad = torch.sqrt(zz ** 2 + yy ** 2 + xx ** 2)
        pos_n = torch.stack(torch.broadcast_tensors(xx, yy, zz), dim=-1) \
            .to(torch.float32) / torch.clamp(rad, min=1.0)[..., None]
        mask_t = torch.as_tensor(mask, device=dev)
        noise_reg = (~mask_t) & (rad > r_part)
        if not bool(noise_reg.any()):
            noise_reg = ~mask_t
        noise_idx = torch.nonzero(noise_reg.reshape(-1)).reshape(-1)
        hw = max(0.5 * (freqs[1:] - freqs[:-1]).mean()
                 if len(freqs) > 1 else 0.03, 0.015)

        F = torch.fft.rfftn(as_tensor(vol, dev))
        r_t = f64(r)
        bands = torch.stack([((r_t >= f - hw) & (r_t <= f + hw))
                             for f in freqs]).to(torch.float32)  # (K,D,H,Wh)
        fx_t, fy_t, fz_t, rr_t = f64(fx), f64(fy), f64(fz), f64(rr)
        res_dir = torch.empty((n_dirs,) + vol.shape, dtype=torch.float32,
                              device=dev)
        with timed_phase("directions", sync=res_dir):
            for d in range(n_dirs):
                ux, uy, uz = (float(c) for c in dirs[d])
                cosang = ((fx_t * ux + fy_t * uy + fz_t * uz) / rr_t).abs()
                conemask = (cosang >= np.cos(cone)).to(torch.float32)
                res_dir[d] = _direction_resolution(
                    F, conemask, bands, res_vals, mask_t, noise_idx,
                    significance)
        del F, bands, r_t
        self._maps(res_dir, mask_t, dirs, pos_n, rad, Ts, D,
                   percentile_linear)

    def _maps(self, res_dir, mask, dirs, pos_n, rad, Ts, D,
              percentile_linear):
        """The per-voxel statistics over directions
        (radialAzimuthalResolution, resolution_directional.cpp:1078-1251)
        and the outputs."""
        dev = res_dir.device
        root = self.getParam("--oroot")
        n_dirs = len(dirs)
        sel = torch.nonzero(mask.reshape(-1)).reshape(-1)
        flat = res_dir.reshape(n_dirs, -1)
        stats = torch.zeros((4, mask.numel()), dtype=torch.float64,
                            device=dev)
        wsums = torch.zeros((4, mask.numel()), dtype=torch.float32,
                            device=dev)
        pos_t = pos_n.reshape(-1, 3)
        dirs32 = torch.as_tensor(dirs.astype(np.float32), device=dev)
        step = max(1, DIR_BLOCK // (8 * n_dirs))
        c45, c70 = np.cos(np.deg2rad(45)), np.cos(np.deg2rad(70))
        for v0 in range(0, len(sel), step):
            v = sel[v0:v0 + step]
            block = flat[:, v]                              # (n_dirs, b)
            stats[:, v] = percentile_linear(block.T, [5, 17, 83, 95]).T
            # radial/azimuthal split by the angle between direction and
            # the voxel position vector (45/70 deg)
            cosvd = (pos_t[v] @ dirs32.to(torch.float64).T).T.abs()
            wrad = (cosvd >= c45).to(torch.float32)
            wazi = (cosvd <= c70).to(torch.float32)
            wsums[0, v] = (block * wrad).sum(dim=0)
            wsums[1, v] = wrad.sum(dim=0)
            wsums[2, v] = (block * wazi).sum(dim=0)
            wsums[3, v] = wazi.sum(dim=0)
        p05, p17, p83, p95 = (s.reshape(mask.shape) for s in stats)
        f32 = lambda x: torch.where(mask, x, 0.0).to(torch.float32)
        highest = f32(p05)
        lowest = f32(p95)
        doa1 = f32(0.5 * (p83 - p17))
        doa2 = f32(0.5 * (p95 + p05))
        rs, nrad, az, nazi = (w.reshape(mask.shape) for w in wsums)
        radial = f32(torch.where(nrad > 0, rs / nrad.clamp(min=1), doa2))
        azimuthal = f32(torch.where(nazi > 0, az / nazi.clamp(min=1), doa2))
        mean_res = f32(res_dir.mean(dim=0))
        if self._opt("--monores"):
            monores = as_tensor(np.squeeze(
                Image(self.getParam("--monores")).data), dev)
        else:
            monores = mean_res
        # z-score of the local resolution against its radial-shell stats
        shell = torch.clamp(rad.to(torch.int64), 0, D // 2)
        (means,), cnt = _shell_means([monores], shell, mask, D // 2 + 1)
        sq, _ = _shell_means([(monores.to(torch.float64)
                               - means[shell]) ** 2], shell, mask,
                             D // 2 + 1)
        sd = torch.sqrt(sq[0]).clamp(min=1e-6)
        ok = mask & (cnt[shell] > 1)
        zmap = torch.where(ok, (monores - means[shell]) / sd[shell], 0.0) \
            .to(torch.float32)
        host = lambda t: t.cpu().numpy()
        write = lambda fn, t: save_image(fn, host(t), sampling=Ts)
        write(self._out("--radialRes", root + "_radial.vol"), radial)
        write(self._out("--azimuthalRes", root + "_azimuthal.vol"), azimuthal)
        write(self._out("--highestResolutionVol", root + "_highest.vol"),
              highest)
        write(self._out("--lowestResolutionVol", root + "_lowest.vol"),
              lowest)
        write(self._out("--doa1", root + "_doa1.vol"), doa1)
        write(self._out("--doa2", root + "_doa2.vol"), doa2)
        write(self._out("-o", root + "_monores.vol"), mean_res)
        if self._opt("--zScoremap"):
            write(self.getParam("--zScoremap"), zmap)
        # 90th-percentile display thresholds
        if self._opt("--radialAzimuthalThresholds"):
            p90 = lambda t: float(percentile_linear(t[mask], [90])[0])
            MetaData.fromRows([{
                "resolutionFreq": p90(radial),
                "resolutionFreq2": p90(azimuthal),
            }]).write(self.getParam("--radialAzimuthalThresholds"))
        # preferred-direction histogram: which direction attains the
        # per-voxel best (minimum) resolution, within 0.1 A
        if self._opt("--prefMin"):
            best = flat[:, sel]
            is_best = (best - highest.reshape(-1)[sel]).abs() < 0.1
            counts = is_best.sum(dim=1)
            mean_per_dir = host(torch.where(
                counts > 0, (best * is_best).sum(dim=1)
                / counts.clamp(min=1), 0.0))
            counts = host(counts)
            tilt = np.degrees(np.arccos(np.clip(dirs[:, 2], -1, 1)))
            rot = np.degrees(np.arctan2(dirs[:, 1], dirs[:, 0]))
            MetaData.fromRows([
                {"angleRot": float(rot[i]), "angleTilt": float(tilt[i]),
                 "weight": float(counts[i]),
                 "resolutionFreq": float(mean_per_dir[i]),
                 "x": float(i), "count": int(counts[i])}
                for i in range(n_dirs)]).write(self.getParam("--prefMin"))
        # radial averages of the five maps
        if self._opt("--radialAvG"):
            rows = []
            maps = (radial, azimuthal, highest, lowest, monores)
            for s in range(1, D // 2):
                ring = mask & ((rad - s).abs() <= 1)
                n = int(ring.sum())
                if not n:
                    continue
                m = [float(x[ring].to(torch.float64).sum()) / n
                     for x in maps]
                rows.append({"resolutionFreq": float(s),
                             "resolutionFreqReal": m[0],
                             "resolutionFreq2": m[1],
                             "resolutionFreqMin": m[2],
                             "resolutionFreqMax": m[3],
                             "resolutionLocal": m[4]})
            MetaData.fromRows(rows).write(self.getParam("--radialAvG"))
        self.mean_resolution = float(mean_res[mask].to(torch.float64).mean())
        self.mean_anisotropy = float(doa1[mask].to(torch.float64).mean())
        if self.verbose:
            print(f"mean directional resolution {self.mean_resolution:.2f} A"
                  f"  anisotropy {self.mean_anisotropy:.2f} A")


class ProgCTFEstimatePSDWithARMA(XmippProgram):
    name = "xmipp_ctf_estimate_psd_with_arma"

    def defineParams(self):
        self.addUsageLine("PSD estimation with a 2-D causal ARMA spectral "
                          "model (reference CausalARMA, "
                          "ctf_estimate_psd_with_arma.cpp:92: AR part by "
                          "Yule-Walker normal equations, MA part from the "
                          "AR-whitened autocovariance).")
        self.addParamsLine("   -i <micrograph> : Input micrograph")
        self.addParamsLine("   -o <psd>        : Output PSD (centered)")
        self.addParamsLine("  [--N_horizontal <n=12>] : AR order (x)")
        self.addParamsLine("  [--N_vertical <n=12>]   : AR order (y)")
        self.addParamsLine("  [--N_MA <n=6>]  : MA order (y; 0 = pure AR)")
        self.addParamsLine("  [--M_MA <n=6>]  : MA order (x; 0 = pure AR)")
        self.addParamsLine("  [--pieceDim <d=256>] : Analysis piece size")

    def run(self):
        from xmipp3_tpu_torch.ops.arma import causal_arma_psd
        from xmipp3_tpu_torch.ops.psd import extract_tiles
        mic = np.squeeze(Image(self.getParam("-i")).data).astype(np.float64)
        p = self.getIntParam("--pieceDim")
        tiles = extract_tiles(mic.astype(np.float32), p, 0.5)
        with timed_phase("arma"):
            psd, sigma2 = causal_arma_psd(
                tiles, p, Nh=self.getIntParam("--N_horizontal"),
                Nv=self.getIntParam("--N_vertical"),
                N_MA=self.getIntParam("--N_MA"),
                M_MA=self.getIntParam("--M_MA"))
        save_image(self.getParam("-o"),
                   np.fft.fftshift(psd).astype(np.float32))
        self.sigma2 = sigma2


class ProgPSDEstimate(XmippProgram):
    """Periodogram PSD of a micrograph (the reference psd_estimate program,
    psd_estimate_main.cpp over PSDEstimator::estimatePSD,
    psd_estimator.cpp:74) — distinct from the ARMA-model program
    ctf_estimate_psd_with_arma."""
    name = "xmipp_psd_estimate"

    def defineParams(self):
        self.addUsageLine("Estimate the PSD of a micrograph by averaged "
                          "overlapping periodograms.")
        self.addParamsLine("   -i <input_file> : Micrograph to be analyzed")
        self.addParamsLine("   -o <output_file> : PSD to be stored")
        self.addParamsLine("  [--overlap <o=0.4>] : overlap of the patches")
        self.addParamsLine("  [--patches <x=384> <y=384>] : size of the patches")
        self.addParamsLine("  [--threads <t=4>] : for FFT (accepted for CLI parity; the FFT is batched on the card)")
        self.addParamsLine("  [--skipNormalization] : if not present, FFT will be centered, and log_10 applied")

    def run(self):
        from xmipp3_tpu_torch.device import resolve_device
        from xmipp3_tpu_torch.ops.psd import estimate_psd_reference
        device = resolve_device(self.getParam("--device"))
        mic = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        toks = self.getListParam("--patches")
        px, py = int(float(toks[0])), int(float(toks[1]))
        normalize = not self.checkParam("--skipNormalization")
        with timed_phase("psd"):
            psd = estimate_psd_reference(
                mic, overlap=float(self.getDoubleParam("--overlap")),
                patch=(px, py), normalize=normalize, device=device)
        Image(np.fft.fftshift(psd) if normalize else psd).write(
            self.getParam("-o"))


class ProgClassifyCL2DCoreAnalysis(XmippProgram):
    """The reference's surface (mpi_classify_CL2D_core_analysis.cpp:54-94):
    walks the CL2D hierarchy <dir>/level_%02d/<root>_classes.xmd and either
    (--computeCore <thPCAZscore> <NPCA>) removes the PCA-Mahalanobis
    outliers of every class block, writing <root>_classes_core.xmd per
    level, or (--computeStableCore <tolerance>) keeps only the images whose
    co-occurrence over every lower level is level - tolerance, writing
    <root>_classes_stable_core.xmd. Each class's EM-PCA runs on the card;
    the co-occurrence counts are numpy products over the class's labels."""
    name = "xmipp_classify_CL2D_core_analysis"

    def defineParams(self):
        self.addUsageLine("Compute the class cores (PCA-outlier removal) "
                          "or stable cores (coocurrence across levels) of "
                          "a CL2D hierarchy.")
        self.addParamsLine("   --root <rootname> : Rootname of the CL2D")
        self.addParamsLine("   --dir <dir>       : Output directory of the "
                           "CL2D")
        self.addParamsLine("  [--computeCore <thPCAZscore=3> <NPCA=2>] : "
                           "Threshold the Zscore of the class images' "
                           "projections onto an NPCA-dim PCA space")
        self.addParamsLine("  [--computeStableCore <tolerance=1>] : Keep "
                           "images that stayed together in the whole "
                           "hierarchy (up to <tolerance> levels)")

    @staticmethod
    def _levels(odir, root, suffix=""):
        levels = []
        while True:
            fn = os.path.join(odir, f"level_{len(levels):02d}",
                              root + "_classes" + suffix + ".xmd")
            if not os.path.exists(fn):
                return levels
            levels.append(fn)

    @staticmethod
    def _class_blocks(fn):
        """[(block name, rows)] of the class%06d_images blocks of a level
        file, in file order; the file is parsed once."""
        from xmipp3_tpu_torch.core.star import read_star
        return [(b.name, list(MetaData(b.df).iterRows()))
                for b in read_star(fn)
                if b.name.startswith("class") and b.name.endswith("_images")]

    @staticmethod
    def _block_images(blocks):
        """{block: its rows' images (n, H, W) float64} of the blocks with
        more than two rows, read in one pass in stack order (the blocks
        hold the views in class order, scattered over the stack)."""
        from xmipp3_tpu_torch.core.filename import as_filename
        flat = [(b, i, r) for b, rows in blocks if len(rows) > 2
                for i, r in enumerate(rows)]
        if not flat:
            return {}
        where = lambda r: (as_filename(r["image"]).path,
                           as_filename(r["image"]).slice_index or 0)
        flat.sort(key=lambda t: where(t[2]))
        imgs = load_image_rows([r for _, _, r in flat])
        out = {b: np.empty((len(rows),) + imgs.shape[1:])
               for b, rows in blocks if len(rows) > 2}
        for (b, i, _), img in zip(flat, imgs):
            out[b][i] = img
        return out

    @staticmethod
    def _write_level(fn_out, blocks):
        """blocks: (block name, kept rows); then the classes@ block."""
        for j, (blk, keep) in enumerate(blocks):
            MetaData.fromRows(keep).write(fn_out, block=blk, append=j > 0)
        MetaData.fromRows([{"ref": int(blk[5:11]), "classCount": len(keep)}
                           for blk, keep in blocks]).write(
            fn_out, block="classes", append=True)
        return sum(len(keep) for _, keep in blocks)

    def _compute_cores(self, odir, root, th_z, npca, device):
        from xmipp3_tpu_torch.models.dimred import empca
        level_files = self._levels(odir, root)
        if not level_files:
            raise XmippError(ErrCode.ARG_MISSING,
                             "Cannot find any CL2D analysis in " + odir)
        n_kept = 0
        for fn in level_files:
            blocks = []
            with timed_phase("read images"):
                level = self._class_blocks(fn)
                images = self._block_images(level)
            for blk, rows in level:
                keep = rows
                if len(rows) > 2:
                    imgs = images[blk]
                    n = imgs.shape[-1]
                    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
                    mask = (yy * yy + xx * xx) <= (n / 2) ** 2
                    d = max(min(npca, len(rows) - 1), 1)
                    with timed_phase("pca"):
                        Y = empca(imgs[:, mask], d=d, n_iters=10,
                                  device=device)
                    std = Y.std(axis=0) + 1e-12
                    dist = np.sqrt(((Y / std) ** 2).mean(axis=1))
                    keep = [r for r, dd in zip(rows, dist) if dd <= th_z]
                blocks.append((blk, keep))
            with timed_phase("write outputs"):
                n_kept += self._write_level(
                    fn.replace("_classes.xmd", "_classes_core.xmd"), blocks)
        self.n_core = n_kept

    def _compute_stable_cores(self, odir, root, tolerance):
        level_files = self._levels(odir, root, suffix="_core")
        if not level_files:            # the raw hierarchy instead
            level_files = self._levels(odir, root)
        memberships = []               # per level: {image -> class block}
        level_blocks = [self._class_blocks(fn) for fn in level_files]
        for blocks in level_blocks:
            memberships.append({str(r["image"]): blk
                                for blk, rows in blocks for r in rows})
        n_kept = 0
        for lev, fn in enumerate(level_files):
            if lev <= tolerance:
                continue
            fn_out = fn.replace("_classes_core", "_classes_stable_core") \
                if "_classes_core" in fn else \
                fn.replace("_classes", "_classes_stable_core")
            blocks = []
            for blk, rows in level_blocks[lev]:
                names = [str(r["image"]) for r in rows]
                keep_mask = np.zeros(len(names), bool)
                if len(names) > 1:
                    # co-occurrence over every lower level
                    # (mpi_classify_CL2D_core_analysis.cpp:196-271): the
                    # pairs i < j that share a class there, counted
                    cooc = np.zeros((len(names),) * 2, np.int32)
                    for m in memberships[:lev]:
                        labels = [m.get(nm) for nm in names]
                        codes = {b: c for c, b in enumerate(
                            sorted({b for b in labels if b is not None}))}
                        lab = np.array([codes.get(b, -1) for b in labels])
                        cooc += np.triu((lab[:, None] == lab[None, :])
                                        & (lab[:, None] >= 0), 1)
                    ii, jj = np.nonzero(cooc == lev - tolerance)
                    keep_mask[ii] = True
                    keep_mask[jj] = True
                blocks.append((blk, [r for r, k in zip(rows, keep_mask)
                                     if k]))
            with timed_phase("write outputs"):
                n_kept += self._write_level(fn_out, blocks)
        self.n_core = n_kept

    def run(self):
        device = resolve_device(self.getParam("--device"))
        odir = self.getParam("--dir")
        root = self.getParam("--root")
        if self.checkParam("--computeCore"):
            self._compute_cores(odir, root,
                                self.getDoubleParam("--computeCore", 0),
                                self.getIntParam("--computeCore", 1),
                                device)
        elif self.checkParam("--computeStableCore"):
            self._compute_stable_cores(
                odir, root, self.getIntParam("--computeStableCore", 0))
        else:
            raise XmippError(ErrCode.ARG_MISSING,
                             "give either --computeCore or "
                             "--computeStableCore")


class ProgAngularAccuracyPCA(XmippProgram):
    """Per-particle accuracy score: each particle is registered by its pose,
    its reprojection (or its --i2 neighbour) subtracted, and the residuals'
    top-5 principal components found on the card (models/dimred.pca);
    scoreByPcaResidual = 1 / (1 + u / median(u)), u being the norm of the
    residual that the components leave unexplained."""
    name = "xmipp_angular_accuracy_pca"

    def defineParams(self):
        self.addUsageLine("Per-particle angular assignment accuracy via PCA "
                          "of the projection neighborhood residuals.")
        self.addParamsLine("   -i <md_file>  : Particles with poses")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("  [-o <md=\"\">]   : Output with accuracy scores")
        self.addParamsLine("  [--i2 <md_file=\"\">] : Metadata with "
                           "neighbour projections to use as references "
                           "instead of reprojecting --ref")
        self.addParamsLine("  [--dim <d=-1>] : Rescale images to this size "
                           "if larger (-1 = no rescaling)")

    def run(self):
        from xmipp3_tpu_torch.models.dimred import pca
        from xmipp3_tpu_torch.ops.geo import apply_md_geometry
        from xmipp3_tpu_torch.ops.project import FourierProjector
        from xmipp3_tpu_torch.ops.resize import (fourier_resize_2d,
                                                 fourier_resize_3d)
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        with timed_phase("read images"):
            imgs = torch.as_tensor(load_image_rows(rows), device=dev)
            vol = np.squeeze(Image(self.getParam("--ref")).data) \
                .astype(np.float32)
        dim = self.getIntParam("--dim")
        if dim > 0 and imgs.shape[-1] > dim:
            imgs = fourier_resize_2d(imgs, dim, dim)
            vol = fourier_resize_3d(vol, dim, dim, dim,
                                    device=dev).cpu().numpy()
        get = lambda k: np.array([float(r.get(k, 0.0)) for r in rows],
                                 np.float32)
        with timed_phase("residuals", sync=imgs):
            reg = apply_md_geometry(
                imgs, get("anglePsi"), get("shiftX"), get("shiftY"),
                np.array([bool(r.get("flip", 0)) for r in rows]))
            if self.checkParam("--i2") and self.getParam("--i2"):
                nb = MetaData(self.getParam("--i2"))
                refs = torch.as_tensor(load_image_rows(
                    list(nb.iterRows()))[:len(rows)], device=dev)
                if refs.shape[-1] != imgs.shape[-1]:
                    refs = fourier_resize_2d(refs, imgs.shape[-1],
                                             imgs.shape[-1])
                if len(refs) < len(rows):
                    refs = torch.cat([refs, refs[-1:].expand(
                        len(rows) - len(refs), -1, -1)])
            else:
                refs = FourierProjector(vol, device=dev).project_euler(
                    get("angleRot"), get("angleTilt"),
                    np.zeros(len(rows), np.float32))
            resid = (reg - refs).reshape(len(rows), -1).to(torch.float64)
        with timed_phase("pca", sync=resid):
            Y, model = pca(resid, d=min(5, len(rows) - 1),
                           return_model=True)
            # the residual energy that the common modes do not explain
            recon = torch.as_tensor(Y, device=dev) @ torch.as_tensor(
                model["components"], device=dev)
            unexplained = torch.linalg.vector_norm(
                resid - torch.as_tensor(model["mean"], device=dev) - recon,
                dim=1).cpu().numpy()
        score = 1.0 / (1.0 + unexplained / max(np.median(unexplained), 1e-9))
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["scoreByPcaResidual"] = float(score[i])
            out.append(d)
        if self.checkParam("-o") and self.getParam("-o"):
            MetaData.fromRows(out).write(self.getParam("-o"))
        self.scores = score


PROGRAM = None  # registered individually
