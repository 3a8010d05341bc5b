"""Small transform programs: window, add_noise, threshold, mirror,
randomize_phases, downsample.

Contracts: the reference package's programs/transform_misc.py (reference
transform_* programs; threshold.h:38, transform_downsample.h,
data/xmipp_image_over for window). Each batch goes to the program's device
(--device; the card by default) and is transformed there, in float32. The
random numbers are drawn on the host from numpy Generators exactly as the
reference draws them (the same seeds, calls, shapes and float64 draws cast
to float32), then moved to the card, so that a --seed run equals the
reference's to float32 roundoff. The window's --corners, --unitcell and
volume modes stay host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
from xmipp3_tpu_torch.ops.fourier import radial_freq_2d
from xmipp3_tpu_torch.ops.geo import window_2d
from xmipp3_tpu_torch.ops.resize import fourier_resize_2d


class ProgTransformWindow(XmippMetadataProgram):
    """Reference transform_window.cpp: --size/--crop/--corners(+--physical)
    /--unitcell modes with value/corner/avg padding."""

    name = "xmipp_transform_window"

    def defineProcessParams(self):
        self.addUsageLine("Crop or pad images to a new size (centered).")
        self.addParamsLine("[--size <x> <y=0> <z=0>] : New size")
        self.addParamsLine("[--crop <x> <y=0> <z=0>] : Crop this many pixels (negative pads; half each side)")
        self.addParamsLine("[--corners <...>] : Window corners, 2D <x0> <y0> <xF> <yF>, 3D <x0> <y0> <z0> <xF> <yF> <zF> (logical indexes)")
        self.addParamsLine("[--physical] : corners are physical (0-based array) indexes")
        self.addParamsLine("[--unitcell <...>] : <sym> <rmin=0> <rmax=0> <expandFactor=0> <offset=0> <sampling=1> <x_origin=-1> <y_origin=-1> <z_origin=-1> : extract a symmetry unit cell from a volume")
        self.addParamsLine("[--pad <padtype=value>] : value used for padding")
        self.addParamsLine("   where <padtype>")
        self.addParamsLine("      value <v=0> : use this value")
        self.addParamsLine("      corner      : use the top-left corner value")
        self.addParamsLine("      avg         : use the image average")
        self.addParamsLine("[--fill_value <v=0>] : (deprecated) same as --pad value v")

    def readProcessParams(self):
        self.size = None
        self.crop = None
        self.corners = None
        self.unitcell = None
        self.physical = self.checkParam("--physical")
        if self.checkParam("--size"):
            x = self.getIntParam("--size", 0)
            y = self.getIntParam("--size", 1)
            z = self.getIntParam("--size", 2)
            self.size = (x, x if y <= 0 else y, x if z <= 0 else z)
        elif self.checkParam("--crop"):
            x = self.getIntParam("--crop", 0)
            y = self.getIntParam("--crop", 1)
            z = self.getIntParam("--crop", 2)
            # historical CLI used -1 as "same"; reference uses 0
            self.crop = (x, x if y in (0, -1) else y, x if z in (0, -1) else z)
        elif self.checkParam("--corners"):
            self.corners = [int(t) for t in self.getListParam("--corners")]
            if len(self.corners) not in (4, 6):
                raise ValueError("--corners takes 4 (2D) or 6 (3D) values")
        elif self.checkParam("--unitcell"):
            toks = self.getListParam("--unitcell")
            self.unitcell = dict(
                sym=toks[0],
                rmin=float(toks[1]) if len(toks) > 1 else 0.0,
                rmax=float(toks[2]) if len(toks) > 2 else 0.0,
                expand=float(toks[3]) if len(toks) > 3 else 0.0,
                offset=float(toks[4]) if len(toks) > 4 else 0.0)
        ptoks = self.getListParam("--pad") if self.checkParam("--pad") \
            else ["value", "0"]
        self.pad_type = ptoks[0]
        self.pad_value = float(ptoks[1]) if len(ptoks) > 1 else 0.0
        if self.checkParam("--fill_value"):
            self.pad_type = "value"
            self.pad_value = self.getDoubleParam("--fill_value")

    def _fill(self, img):
        if self.pad_type == "corner":
            return float(np.ravel(img)[0])
        if self.pad_type == "avg":
            return float(img.mean())
        return self.pad_value

    def _window_nd(self, img, lo, hi):
        """Logical-corner window of a 2-D or 3-D array ((y0,x0)/(z0,y0,x0)
        ordering in lo/hi), out-of-range padded with the fill policy."""
        nd = img.ndim
        ctr = [s // 2 for s in img.shape]
        out_shape = tuple(h - l + 1 for l, h in zip(lo, hi))
        out = np.full(out_shape, self._fill(img), img.dtype)
        src = []
        dst = []
        for d in range(nd):
            s0 = lo[d] + ctr[d]
            s1 = hi[d] + ctr[d] + 1
            d0 = max(0, -s0)
            s0c = max(0, s0)
            s1c = min(img.shape[d], s1)
            if s1c <= s0c:
                return out
            src.append(slice(s0c, s1c))
            dst.append(slice(d0, d0 + (s1c - s0c)))
        out[tuple(dst)] = img[tuple(src)]
        return out

    def _unitcell_volume(self, vol):
        """TPU-first unit cell: mask voxels whose direction is the
        orbit-canonical representative under the symmetry group (a valid
        fundamental domain; the reference's unitCell.cpp picks a
        plane-bounded one instead — same coverage property: the orbit of
        the cell tiles the sphere), shell-limited to [rmin, rmax] and
        dilated by the expand factor, then cropped to the bounding box."""
        from xmipp3_tpu_torch.core.sym import symmetry_matrices
        uc = self.unitcell
        G = np.asarray(symmetry_matrices(uc["sym"]), np.float64)
        n = vol.shape[0]
        zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float64) - n // 2
        r = np.sqrt(xx * xx + yy * yy + zz * zz)
        if uc["offset"]:
            a = np.deg2rad(uc["offset"])
            c, s = np.cos(a), np.sin(a)
            xx, yy = c * xx - s * yy, s * xx + c * yy
        pts = np.stack([xx, yy, zz], axis=-1)          # (n,n,n,3)
        # orbit-canonical: keep voxels maximizing a fixed score over the
        # orbit (z, then y, then x lexicographic via weighted sum)
        w = np.array([1.0, n * 2.0, n * n * 4.0])
        score = None
        best = None
        for R in G:
            q = pts @ R.T
            s_ = q @ w
            if score is None:
                score, best = s_, s_
            else:
                best = np.maximum(best, s_)
        own = (pts @ w) >= best - 1e-9
        rmin, rmax = uc["rmin"], uc["rmax"] or (n // 2)
        mask = own & (r >= rmin) & (r <= rmax)
        if uc["expand"] > 0:
            from scipy.ndimage import binary_dilation
            it = max(1, int(round(uc["expand"] * 4)))
            mask = binary_dilation(mask, iterations=it) & \
                (r >= max(0.0, rmin - it)) & (r <= rmax + it)
        out = np.where(mask, vol, self._fill(vol)).astype(vol.dtype)
        idx = np.argwhere(mask)
        if idx.size:
            lo = idx.min(axis=0)
            hi = idx.max(axis=0) + 1
            out = out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        return out

    def processBatch(self, imgs, rows):
        is_vol = imgs.ndim == 4
        if self.unitcell is not None:
            if not is_vol:
                raise ValueError("--unitcell needs a volume input")
            return np.stack([self._unitcell_volume(v) for v in imgs])
        if self.corners is not None:
            c = self.corners
            out = []
            for img in imgs:
                if len(c) == 4:
                    lo, hi = (c[1], c[0]), (c[3], c[2])
                    if self.physical:
                        ctr = [s // 2 for s in img.shape[-2:]]
                        lo = tuple(v - k for v, k in zip(lo, ctr))
                        hi = tuple(v - k for v, k in zip(hi, ctr))
                else:
                    lo, hi = (c[2], c[1], c[0]), (c[5], c[4], c[3])
                    if self.physical:
                        ctr = [s // 2 for s in img.shape[-3:]]
                        lo = tuple(v - k for v, k in zip(lo, ctr))
                        hi = tuple(v - k for v, k in zip(hi, ctr))
                out.append(self._window_nd(img, lo, hi))
            return np.stack(out)
        if is_vol:
            Z, H, W = imgs.shape[-3:]
            if self.size:
                ow, oh, oz = self.size
            else:
                ow, oh, oz = W - self.crop[0], H - self.crop[1], \
                    Z - self.crop[2]
            out = []
            for v in imgs:
                lo = (-(oz // 2), -(oh // 2), -(ow // 2))
                hi = (oz - oz // 2 - 1, oh - oh // 2 - 1, ow - ow // 2 - 1)
                out.append(self._window_nd(v, lo, hi))
            return np.stack(out)
        H, W = imgs.shape[-2:]
        if self.size:
            out_w, out_h = self.size[0], self.size[1]
        else:
            out_w, out_h = W - self.crop[0], H - self.crop[1]
        x = torch.as_tensor(imgs, device=self.device)
        if self.pad_type == "value":
            return window_2d(x, out_h, out_w, fill=self.pad_value)
        return torch.stack([window_2d(x[i], out_h, out_w,
                                      fill=self._fill(img))
                            for i, img in enumerate(imgs)])


class ProgTransformAddNoise(XmippMetadataProgram):
    name = "xmipp_transform_add_noise"

    def defineProcessParams(self):
        self.addUsageLine("Add random noise to images.")
        self.addParamsLine("[--type <noise_type=gaussian>] : Noise model")
        self.addParamsLine("    where <noise_type>")
        self.addParamsLine("       gaussian <stddev=1> <avg=0> : Gaussian noise")
        self.addParamsLine("       student <df=3> <stddev=1> <avg=0> : t-Student noise")
        self.addParamsLine("       uniform <min=0> <max=1>     : Uniform noise")
        self.addParamsLine("[--limit0 <low=0>] : Crop the noise histogram below this value")
        self.addParamsLine("[--limitF <high=0>] : Crop the noise histogram above this value")
        self.addParamsLine("[--seed <s=-1>] : Random seed (-1 = nondeterministic)")

    def readProcessParams(self):
        toks = self.getListParam("--type") or ["gaussian", "1", "0"]
        self.noise_type = toks[0]
        self.noise_args = [float(t) for t in toks[1:]]
        self.limit0 = (self.getDoubleParam("--limit0")
                       if self.checkParam("--limit0") else None)
        self.limitF = (self.getDoubleParam("--limitF")
                       if self.checkParam("--limitF") else None)
        seed = self.getIntParam("--seed") if self.checkParam("--seed") else -1
        self.rng = np.random.default_rng(None if seed < 0 else seed)

    def _crop(self, noise):
        # reference init_random with limits: the noise histogram is cropped
        # (transform_add_noise.cpp:56-57, --limit0/--limitF)
        if self.limit0 is not None:
            noise = np.maximum(noise, self.limit0)
        if self.limitF is not None:
            noise = np.minimum(noise, self.limitF)
        return noise

    def _noise(self, shape):
        """The batch's noise, drawn on the host as the reference draws it."""
        t = self.noise_type
        if t == "gaussian":
            std = self.noise_args[0] if self.noise_args else 1.0
            avg = self.noise_args[1] if len(self.noise_args) > 1 else 0.0
            return self._crop(self.rng.normal(avg, std, shape))
        if t == "student":
            df, std = self.noise_args[0], self.noise_args[1] if \
                len(self.noise_args) > 1 else 1.0
            avg = self.noise_args[2] if len(self.noise_args) > 2 else 0.0
            return self._crop(avg + std * self.rng.standard_t(df, shape))
        if t == "uniform":
            lo = self.noise_args[0] if self.noise_args else 0.0
            hi = self.noise_args[1] if len(self.noise_args) > 1 else 1.0
            return self._crop(self.rng.uniform(lo, hi, shape))
        raise ValueError(t)

    def processBatch(self, imgs, rows):
        noise = self._noise(imgs.shape).astype(np.float32)
        return torch.as_tensor(imgs, device=self.device) + \
            torch.as_tensor(noise, device=self.device)


class ProgTransformThreshold(XmippMetadataProgram):
    name = "xmipp_transform_threshold"

    def defineProcessParams(self):
        self.addUsageLine("Threshold image values (reference threshold.h:38).")
        self.addParamsLine(" --select <mode>  : Select values")
        self.addParamsLine("    where <mode>")
        self.addParamsLine("       abs_below <th> : |v| below threshold")
        self.addParamsLine("       below <th>     : v below threshold")
        self.addParamsLine("       above <th>     : v above threshold")
        self.addParamsLine("[--substitute <sub_mode=value>] : Replace by")
        self.addParamsLine("    where <sub_mode>")
        self.addParamsLine("       binarize  : selected 0, rest 1")
        self.addParamsLine("       value <new=0> : a constant")
        self.addParamsLine("       noise <avg=0> <stddev=1> : random values")

    def readProcessParams(self):
        toks = self.getListParam("--select")
        self.mode, self.th = toks[0], float(toks[1])
        stoks = self.getListParam("--substitute") or ["value", "0"]
        self.sub = stoks[0]
        self.sub_args = [float(t) for t in stoks[1:]]

    def processBatch(self, imgs, rows):
        x = torch.as_tensor(imgs, device=self.device)
        th = self.th
        if self.mode == "abs_below":
            sel = x.abs() < th
        elif self.mode == "below":
            sel = x < th
        else:
            sel = x > th
        if self.sub == "binarize":
            return (~sel).to(torch.float32)
        if self.sub == "noise":
            avg = self.sub_args[0] if self.sub_args else 0.0
            std = self.sub_args[1] if len(self.sub_args) > 1 else 1.0
            # the reference draws each batch from a new Generator(0)
            noise = np.random.default_rng(0).normal(avg, std, imgs.shape)
            return torch.where(sel, torch.as_tensor(
                noise.astype(np.float32), device=self.device), x)
        val = self.sub_args[0] if self.sub_args else 0.0
        return torch.where(sel, torch.tensor(val, dtype=torch.float32,
                                             device=self.device), x)


class ProgTransformMirror(XmippMetadataProgram):
    name = "xmipp_transform_mirror"

    def defineProcessParams(self):
        self.addUsageLine("Mirror images about an axis.")
        self.addParamsLine("[--flipX] : Mirror in X")
        self.addParamsLine("[--flipY] : Mirror in Y")
        self.addParamsLine("[--flipZ] : Mirror in Z (volumes)")

    def readProcessParams(self):
        self.fx = self.checkParam("--flipX")
        self.fy = self.checkParam("--flipY")
        self.fz = self.checkParam("--flipZ")

    def processBatch(self, imgs, rows):
        out = torch.as_tensor(imgs, device=self.device)
        if self.fx:
            out = out.flip(-1)
        if self.fy:
            out = out.flip(-2)
        if self.fz and out.ndim >= 3:
            out = out.flip(-3)
        return out


class ProgTransformRandomizePhases(XmippMetadataProgram):
    name = "xmipp_transform_randomize_phases"

    def defineProcessParams(self):
        self.addUsageLine("Randomize Fourier phases beyond a frequency "
                          "(gold-standard FSC validation input).")
        self.addParamsLine("[--freq <w=0.25>] : Digital frequency above which phases are randomized")
        self.addParamsLine("[--seed <s=0>]    : Random seed")

    def readProcessParams(self):
        self.freq = self.getDoubleParam("--freq") if self.checkParam("--freq") else 0.25
        self.seed = self.getIntParam("--seed") if self.checkParam("--seed") else 0

    def processBatch(self, imgs, rows):
        H, W = imgs.shape[-2:]
        dev = self.device
        r = torch.as_tensor(radial_freq_2d(H, W), device=dev)
        # every batch draws from a new Generator(seed), as in the reference
        rng = np.random.default_rng(self.seed)
        spec = torch.fft.rfft2(torch.as_tensor(imgs, device=dev))
        phases = rng.uniform(0, 2 * np.pi, tuple(spec.shape)).astype(
            np.float32)
        # Hermitian consistency at the self-conjugate rfft columns
        # (kx = 0 and kx = W/2): phase(-ky) = -phase(ky), so the irfft
        # preserves the amplitude there instead of silently averaging the
        # inconsistent halves away
        for c in (0, W // 2):
            if c < phases.shape[-1]:
                half = (H - 1) // 2
                phases[..., H - half:, c] = -phases[..., 1:half + 1, c][
                    ..., ::-1]
                phases[..., 0, c] = 0.0
                if H % 2 == 0:
                    phases[..., H // 2, c] = 0.0
        rand = torch.polar(spec.abs(), torch.as_tensor(phases, device=dev))
        out_spec = torch.where(r[None] > self.freq, rand, spec)
        return torch.fft.irfft2(out_spec, s=(H, W))


class ProgTransformDownsample(XmippMetadataProgram):
    name = "xmipp_transform_downsample"

    def defineProcessParams(self):
        self.addUsageLine("Downsample micrographs/images (Fourier crop).")
        self.addParamsLine(" --step <factor> : Downsampling factor (>1)")
        self.addParamsLine("[--method <mth=fourier>] : fourier | smooth")

    def readProcessParams(self):
        self.factor = self.getDoubleParam("--step")
        method = self.getParam("--method") if self.checkParam("--method") \
            else "fourier"
        if method != "fourier":
            # the reference accepts --method and always crops in Fourier
            # space (ROADMAP.md section 3, item 11)
            raise XmippError(ErrCode.ARG_INCORRECT,
                             f"--method {method}: only the Fourier crop is "
                             "implemented")

    def processBatch(self, imgs, rows):
        H, W = imgs.shape[-2:]
        oh = int(round(H / self.factor / 2)) * 2
        ow = int(round(W / self.factor / 2)) * 2
        return fourier_resize_2d(imgs, oh, ow, device=self.device)


PROGRAM = None  # multi-program module; see registry
