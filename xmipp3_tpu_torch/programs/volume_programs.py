"""Volume programs of the reference package's programs/volume_programs.py:
xmipp_volume_from_pdb, xmipp_volume_center, xmipp_volume_align,
xmipp_volume_subtraction, xmipp_volume_segment, xmipp_transform_mask,
xmipp_transform_symmetrize and xmipp_volume_to_pseudoatoms (reference
volume_from_pdb, volume_center, volume_align_prog, volume_subtraction
(volume_subtraction.h:33), volume_segment, ProgMask (data/mask.h:1039),
symmetrize (symmetrize.h:39), volume_to_pseudoatoms
(volume_to_pseudoatoms.h:72)).

Each runs on the card unless `--device cpu` is given: the centring phase
ramp, volume_align's trial warps and fitness (16 warps a chunk), the FRM
search, the POCS adjustment, the masks' application, the 2-D
symmetrisation and the pseudo-atoms' rendering and gradient steps
(torch.autograd through two float32 einsums). The atom splatting, the
Otsu threshold, the 3-D symmetrisation (scipy's affine_transform and
map_coordinates), volume_align's shift search and Powell driver, and the
pseudo-atoms' seeding and removal stay on the host, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, fp32_products, resolve_device


class ProgVolumeFromPDB(XmippProgram):
    """Full reference surface (volume_from_pdb.cpp:185-560): scattering-
    profile (default), --blobs, --poor_Gaussian and --fixed_Gaussian
    atom splatting, --high_sampling_rate rasterize-then-downscale,
    per-axis --size, --orig origin, --noHet, --centerPDB/--oPDB and
    --intensityColumn weight selection."""
    name = "xmipp_volume_from_pdb"

    def defineParams(self):
        self.addUsageLine("Rasterize an atomic model (PDB/mmCIF) into a "
                          "voxel volume.")
        self.addParamsLine("   -i <pdb_file> : Input atomic model")
        self.addParamsLine("  [-o <root=\"\">] : Output rootname (.vol)")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (Å)")
        self.addParamsLine("  [--high_sampling_rate <hTs=-1>] : Rasterize "
                           "at this finer sampling, then downscale")
        self.addParamsLine("  [--size <x=-1> <y=-1> <z=-1>] : Final size "
                           "in voxels (-1 = auto; one value = cubic)")
        self.addParamsLine("  [--orig <x=0> <y=0> <z=0>] : Origin of the "
                           "output volume (logical indices)")
        self.addParamsLine("  [--centerPDB]   : Center the model at its "
                           "center of mass")
        self.addParamsLine("  [--oPDB]        : Save the centered model "
                           "to <root>_centered.pdb")
        self.addParamsLine("  [--noHet]       : Skip heteroatoms")
        self.addParamsLine("  [--blobs]       : Kaiser-Bessel blobs "
                           "instead of scattering factors")
        self.addParamsLine("  [--poor_Gaussian] : Simple per-atom Gaussian")
        self.addParamsLine("  [--fixed_Gaussian <std=-1>] : Fixed-sigma "
                           "Gaussian (std<0: per-atom sigma from the "
                           "B-factor column)")
        self.addParamsLine("  [--intensityColumn <c=occupancy>] : Weight "
                           "column in fixed-Gaussian mode: occupancy | "
                           "Bfactor")

    def run(self):
        from xmipp3_tpu_torch.core.pdb import (rasterize_modes, read_pdb,
                                               write_pdb)
        dev = resolve_device(self.getParam("--device"))
        fn = self.getParam("-i")
        model = read_pdb(fn)
        Ts = self.getDoubleParam("--sampling")
        if self.checkParam("--noHet") and model.het is not None:
            model = model.select(~model.het)
        if self.checkParam("--centerPDB"):
            model = model.centered()
        nx = self.getIntParam("--size", 0)
        ny = self.getIntParam("--size", 1)
        nz = self.getIntParam("--size", 2)
        if nx <= 0:
            lim = np.abs(model.coords).max(axis=0)
            n = int(np.ceil(2 * lim.max() / Ts)) + 10
            n += n % 2
            nx = ny = nz = n
        elif ny <= 0:
            ny = nz = nx
        origin = None
        if self.checkParam("--orig"):
            origin = (self.getIntParam("--orig", 0),
                      self.getIntParam("--orig", 1),
                      self.getIntParam("--orig", 2))
            if any(origin):
                origin = origin
            else:
                origin = None
        if self.checkParam("--blobs"):
            mode, sigma = "blobs", -1.0
        elif self.checkParam("--poor_Gaussian"):
            mode, sigma = "poor_gaussian", -1.0
        elif self.checkParam("--fixed_Gaussian"):
            mode = "fixed_gaussian"
            sigma = self.getDoubleParam("--fixed_Gaussian")
        else:
            mode, sigma = "scattering", -1.0
        hTs = (self.getDoubleParam("--high_sampling_rate")
               if self.checkParam("--high_sampling_rate") else -1.0)
        vol = rasterize_modes(model, (nx, ny, nz), Ts, mode=mode,
                              origin=origin, sigma=sigma,
                              intensity=self.getParam("--intensityColumn"),
                              high_sampling=hTs if 0 < hTs < Ts else None,
                              device=dev)
        root = self.getParam("-o") or fn.rsplit(".", 1)[0]
        if self.checkParam("--oPDB") and self.checkParam("--centerPDB"):
            write_pdb(root.replace(".vol", "") + "_centered.pdb", model)
        if not root.endswith(".vol"):
            root += ".vol"
        save_image(root, vol, sampling=Ts)
        if self.verbose:
            print(f"Rasterized {len(model)} atoms into "
                  f"{nx}x{ny}x{nz} at {Ts} A/px ({mode})")


class ProgVolumeCenter(XmippProgram):
    name = "xmipp_volume_center"

    def defineParams(self):
        self.addUsageLine("Center a volume by its center of mass.")
        self.addParamsLine("   -i <volume> : Input volume")
        self.addParamsLine("  [-o <out=\"\">] : Output (default in-place)")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        fn = self.getParam("-i")
        vol = np.squeeze(Image(fn).data).astype(np.float32)
        D, H, W = vol.shape
        m = np.maximum(vol, 0)
        s = m.sum()
        z, y, x = np.mgrid[0:D, 0:H, 0:W].astype(np.float32)
        cz = (m * z).sum() / s - D // 2
        cy = (m * y).sum() / s - H // 2
        cx = (m * x).sum() / s - W // 2
        f32 = lambda f: torch.as_tensor(f.astype(np.float32), device=dev)
        fz = f32(np.fft.fftfreq(D))[:, None, None]
        fy = f32(np.fft.fftfreq(H))[None, :, None]
        fx = f32(np.fft.rfftfreq(W))[None, None, :]
        arg = fx * float(cx) + fy * float(cy) + fz * float(cz)
        phase = torch.polar(torch.ones_like(arg), 2 * np.pi * arg)
        out = torch.fft.irfftn(torch.fft.rfftn(as_tensor(vol, dev)) * phase,
                               s=vol.shape)
        save_image(self.getParam("-o") or fn, out.cpu().numpy())
        self.shift = (-cx, -cy, -cz)


class ProgVolumeAlign(XmippProgram):
    """Full reference flag surface of volume_align_prog.cpp: 10-D trial
    vector (mirror, grey_scale, grey_shift, rot, tilt, psi, scale, z, y, x),
    covariance / least-squares fitness, exhaustive grid / Powell local /
    FRM engines, --copyGeo/--copyGray/--store outputs. The grid
    trials are evaluated on the card in chunks of 16 candidate 3x4
    affines (their warps and fitness)."""

    name = "xmipp_volume_align"

    def defineParams(self):
        self.addUsageLine("Align two volumes.")
        self.addParamsLine("   --i1 <volume1> : the first volume to align")
        self.addParamsLine("   --i2 <volume2> : the second one")
        self.addParamsLine("  [--rot   <rot0=0>  <rotF=0>  <step_rot=1>]  : in degrees")
        self.addParamsLine("  [--tilt  <tilt0=0> <tiltF=0> <step_tilt=1>] : in degrees")
        self.addParamsLine("  [--psi   <psi0=0>  <psiF=0>  <step_psi=1>]  : in degrees")
        self.addParamsLine("  [--scale <sc0=1>   <scF=1>   <step_sc=1>]   : size scale margin")
        self.addParamsLine("  [--grey_scale <sc0=1> <scF=1> <step_sc=1>]  : grey scale margin")
        self.addParamsLine("    requires --least_squares;")
        self.addParamsLine("  [--grey_shift <sh0=0> <shF=0> <step_sh=1>]  : grey shift margin")
        self.addParamsLine("    requires --least_squares;")
        self.addParamsLine("  [-z <z0=0> <zF=0> <step_z=1>] : Z position in pixels")
        self.addParamsLine("  [-y <y0=0> <yF=0> <step_y=1>] : Y position in pixels")
        self.addParamsLine("  [-x <x0=0> <xF=0> <step_x=1>] : X position in pixels")
        self.addParamsLine("  [--consider_mirror] : Consider the mirror volume")
        self.addParamsLine("  [--show_fit]      : Show fitness values")
        self.addParamsLine("  [--apply <file=\"\">] : Apply best movement to --i2 and store here")
        self.addParamsLine("  [--covariance]    : Covariance fitness criterion")
        self.addParamsLine("  [--least_squares] : LS fitness criterion")
        self.addParamsLine("  [--local]         : Use local optimizer instead of exhaustive search")
        self.addParamsLine("  [--frm <maxFreq=0.25> <maxShift=10> <tilt0=-90> <tiltF=90>] : Fast Rotational Matching")
        self.addParamsLine("  [--onlyShift]     : Only shift")
        self.addParamsLine("  [--dontScale]     : Do not look for scale changes")
        self.addParamsLine("  [--copyGeo <file=\"\">] : write the 16 'A' matrix elements to a txt file")
        self.addParamsLine("  [--copyGray <file=\"\">] : write grey scale and shift to a txt file")
        self.addParamsLine("  [--store <file=\"\">] : write angles, shifts and fitness to a txt file")
        self.addParamsLine("  [--dontWrap] : Do not wrap input2 when aligning to input1")
        self.addParamsLine("  [--mask <type=\"\"> <r=0>] : restrict fitness to a mask (circular <r>, or a mask file path)")
        self.addParamsLine("  [--step <s=0>] : framework extra: coarse sphere search at this angular step when no ranges are given")

    # -- reference transform composition (volume_align_prog.cpp:57-97) ---
    @staticmethod
    def _trial_matrix(flip, rot, tilt, psi, scale, z, y, x):
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        A = np.eye(4)
        A[:3, :3] = np.asarray(euler_matrix(float(rot), float(tilt),
                                            float(psi)), np.float64)
        A[:, 2] *= flip
        zz = -z + 1 if flip < 0 else z
        T = np.eye(4)
        T[0, 3], T[1, 3], T[2, 3] = x, y, zz
        S = np.diag([scale, scale, scale, 1.0])
        return A @ T @ S

    def _fitness_batch(self, warped, grey_scale, grey_shift):
        """The fit of each candidate on the card: covariance = -corr,
        least_squares = rms."""
        v1, m = self._v1j, self._maskj
        gs = as_tensor(grey_scale, v1.device)[:, None, None, None]
        gh = as_tensor(grey_shift, v1.device)[:, None, None, None]
        w = warped * gs + gh
        ax = (1, 2, 3)
        nm = torch.sum(m)
        if self.method == "least_squares":
            return torch.sqrt(torch.sum(((v1 - w) ** 2) * m, dim=ax) / nm)
        mu1 = torch.sum(v1 * m) / nm
        muw = torch.sum(w * m, dim=ax) / nm
        d1 = (v1 - mu1) * m
        dw = (w - muw[:, None, None, None]) * m
        num = torch.sum(d1 * dw, dim=ax)
        den = torch.sqrt(torch.sum(d1 ** 2) * torch.sum(dw ** 2, dim=ax))
        return -num / torch.clamp_min(den, 1e-12)

    def _eval_trials(self, trials):
        """trials: (N, 10) rows (flip, gs, gh, rot, tilt, psi, scale, z, y,
        x). The warps and fits run on the card, 16 trials a chunk; the
        fits are read back once."""
        from xmipp3_tpu_torch.ops.geo import apply_affine_3d
        B = 16
        fits = []
        for s in range(0, len(trials), B):
            chunk = trials[s:s + B]
            mats = np.stack([self._trial_matrix(*t[[0, 3, 4, 5, 6, 7, 8, 9]])
                             for t in chunk])[:, :3, :4].astype(np.float32)
            warped = apply_affine_3d(self._v2j, mats, wrap=self.wrap)
            fits.append(self._fitness_batch(
                warped, np.asarray(chunk[:, 1], np.float32),
                np.asarray(chunk[:, 2], np.float32)))
        fits = torch.cat(fits).cpu().numpy().astype(np.float64)
        if self.show_fit:
            for t, f in zip(trials, fits):
                print(" ".join(f"{v:g}" for v in t[1:]) + f" {f:g}")
        return fits

    def _range(self, flag, d0, dF, ds):
        if not self.checkParam(flag):
            return np.array([d0])
        v0 = self.getDoubleParam(flag, 0)
        vF = self.getDoubleParam(flag, 1)
        st = self.getDoubleParam(flag, 2)
        if vF <= v0:
            return np.array([v0])
        return np.arange(v0, vF + 1e-9, max(st, 1e-9))

    def run(self):
        import itertools
        dev = resolve_device(self.getParam("--device"))
        # --frm's tilt0 and tiltF are never read (ROADMAP.md section 3,
        # item 19)
        if self.checkParam("--frm") and any(
                float(self.getParam("--frm", k)) != d
                for k, d in ((2, -90.0), (3, 90.0))):
            raise XmippError(
                ErrCode.ARG_INCORRECT,
                "--frm: the reference never reads its tilt0 and tiltF; the "
                "port refuses values other than -90 90 rather than ignore "
                "them (ROADMAP.md section 3, item 19)")
        v1 = np.squeeze(Image(self.getParam("--i1")).data).astype(np.float32)
        v2 = np.squeeze(Image(self.getParam("--i2")).data).astype(np.float32)
        self._v1, self._v2 = v1, v2
        self._v1j = as_tensor(v1, dev)
        self._v2j = as_tensor(v2, dev)
        self.wrap = not self.checkParam("--dontWrap")
        self.show_fit = self.checkParam("--show_fit")
        self.method = ("least_squares" if self.checkParam("--least_squares")
                       else "covariance")
        mask = np.ones(v1.shape, np.float32)
        if self.checkParam("--mask") and self.getParam("--mask"):
            spec = self.getParam("--mask")
            if spec == "circular":
                from xmipp3_tpu_torch.ops.mask import circular_mask
                mask = np.asarray(circular_mask(
                    v1.shape, abs(self.getDoubleParam("--mask", 1))),
                    np.float32)
            else:
                mask = (np.squeeze(Image(spec).data) > 0.5).astype(np.float32)
        self._maskj = as_tensor(mask, dev)

        mirrors = [1.0, -1.0] if self.checkParam("--consider_mirror") \
            else [1.0]
        if self.checkParam("--frm"):
            best = self._run_frm(v1, v2, mirrors)
        elif self.checkParam("--local"):
            best = self._run_local(mirrors)
        elif self.checkParam("--step") and self.getDoubleParam("--step") > 0 \
                and not any(self.checkParam(f)
                            for f in ("--rot", "--tilt", "--psi")):
            best = self._run_sphere(self.getDoubleParam("--step"), mirrors)
        else:
            axes = [self._range("--grey_scale", 1, 1, 1),
                    self._range("--grey_shift", 0, 0, 1),
                    self._range("--rot", 0, 0, 1),
                    self._range("--tilt", 0, 0, 1),
                    self._range("--psi", 0, 0, 1),
                    self._range("--scale", 1, 1, 1),
                    self._range("-z", 0, 0, 1),
                    self._range("-y", 0, 0, 1),
                    self._range("-x", 0, 0, 1)]
            trials = np.array([(f,) + c for f in mirrors
                               for c in itertools.product(*axes)])
            fits = self._eval_trials(trials)
            k = int(np.argmin(fits))
            best = (fits[k], trials[k])
        self._report(best)

    def _run_sphere(self, step, mirrors):
        """Framework extra: coarse search over the projection sphere."""
        from xmipp3_tpu_torch.core.sampling import compute_sampling_points
        pts = compute_sampling_points(step)
        psis = np.arange(-180.0, 180.0, step)
        trials = np.array([(f, 1.0, 0.0, r, t, p, 1.0, 0.0, 0.0, 0.0)
                           for f in mirrors for r, t in pts for p in psis])
        fits = self._eval_trials(trials)
        k = int(np.argmin(fits))
        return fits[k], trials[k]

    def _run_local(self, mirrors):
        """Powell local optimization (reference usePowell branch)."""
        from scipy.optimize import minimize
        x0 = np.array([
            self.getDoubleParam("--grey_scale", 0) if self.checkParam("--grey_scale") else 1.0,
            self.getDoubleParam("--grey_shift", 0) if self.checkParam("--grey_shift") else 0.0,
            self.getDoubleParam("--rot", 0) if self.checkParam("--rot") else 0.0,
            self.getDoubleParam("--tilt", 0) if self.checkParam("--tilt") else 0.0,
            self.getDoubleParam("--psi", 0) if self.checkParam("--psi") else 0.0,
            self.getDoubleParam("--scale", 0) if self.checkParam("--scale") else 1.0,
            self.getDoubleParam("-z", 0) if self.checkParam("-z") else 0.0,
            self.getDoubleParam("-y", 0) if self.checkParam("-y") else 0.0,
            self.getDoubleParam("-x", 0) if self.checkParam("-x") else 0.0])
        active = np.ones(9, bool)
        if self.checkParam("--onlyShift"):
            active[:6] = False
        if self.method == "covariance":
            active[:2] = False
        if self.checkParam("--dontScale"):
            active[5] = False
        best = None
        for flip in mirrors:
            def f(xa, flip=flip):
                x = x0.copy()
                x[active] = xa
                t = np.concatenate([[flip], x])
                return float(self._eval_trials(t[None])[0])
            res = minimize(f, x0[active], method="Powell",
                           options={"xtol": 0.01, "ftol": 0.01,
                                    "maxiter": 20})
            x = x0.copy()
            x[active] = res.x
            trial = np.concatenate([[flip], x])
            if best is None or res.fun < best[0]:
                best = (res.fun, trial)
        return best

    def _run_frm(self, v1, v2, mirrors):
        """FRM SO(3) alignment (ops.frm) + bounded shift refinement."""
        from xmipp3_tpu_torch.core.geometry import matrix_to_euler
        from xmipp3_tpu_torch.ops.frm import frm_align_volumes
        toks = self.getListParam("--frm")
        max_freq = float(toks[0]) if toks else 0.25
        max_shift = float(toks[1]) if len(toks) > 1 else 10.0
        D = v1.shape[0]
        # legacy framework signature: --frm <L>, L >= 1
        L = int(max_freq) if max_freq >= 1 else \
            int(np.clip(round(2 * max_freq * D), 8, 32))
        best = None
        for flip in mirrors:
            vv = v2[::-1].copy() if flip < 0 else v2
            with timed_phase("frm"):
                M = frm_align_volumes(self._v1j, vv, L=L,
                                      device=self._v1j.device)
            rot, tilt, psi = (float(a) for a in matrix_to_euler(M))
            sz, sy, sx = self._best_shift(v1, vv, M, max_shift)
            trial = np.array([flip, 1.0, 0.0, rot, tilt, psi, 1.0,
                              sz, sy, sx])
            fit = float(self._eval_trials(trial[None])[0]) if flip > 0 \
                else -self._corr_after(vv, M)
            if best is None or fit < best[0]:
                best = (fit, trial)
        self.matrix = np.asarray(
            self._trial_matrix(*best[1][[0, 3, 4, 5, 6, 7, 8, 9]]))[:3, :3]
        return best

    def _rotated(self, v2, M):
        """v2 rotated by M on the card, read back to the host."""
        from xmipp3_tpu_torch.ops.geo import apply_affine_3d
        return apply_affine_3d(v2, M[None].astype(np.float32),
                               device=self._v1j.device)[0].cpu().numpy()

    def _best_shift(self, v1, v2, M, max_shift):
        """Translation by cross-correlation (host float64, as the
        reference) after rotating v2 by M on the card."""
        if max_shift <= 0:
            return 0.0, 0.0, 0.0
        rot = self._rotated(v2, M)
        c = np.real(np.fft.ifftn(np.fft.fftn(v1) *
                                 np.conj(np.fft.fftn(rot))))
        c = np.fft.fftshift(c)
        ctr = np.array(c.shape) // 2
        ms = int(min(max_shift, min(c.shape) // 2 - 1))
        win = c[ctr[0] - ms:ctr[0] + ms + 1, ctr[1] - ms:ctr[1] + ms + 1,
                ctr[2] - ms:ctr[2] + ms + 1]
        k = np.unravel_index(np.argmax(win), win.shape)
        dz, dy, dx = (np.array(k) - ms).astype(float)
        return dz, dy, dx

    def _corr_after(self, v2, M):
        rot = self._rotated(v2, M)
        a = self._v2 * 0 + self._v1
        a = a - a.mean()
        b = rot - rot.mean()
        return float((a * b).sum() /
                     max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))

    def _report(self, best):
        best_fit, t = best
        flip, gs, gh, rot, tilt, psi, scale, z, y, x = t
        A = self._trial_matrix(flip, rot, tilt, psi, scale, z, y, x)
        self.angles = (float(rot), float(tilt), float(psi))
        self.corr = -float(best_fit) if self.method == "covariance" \
            else float(best_fit)
        self.fit = float(best_fit)
        self.matrix_A = A
        if self.verbose:
            print("The best correlation is for")
            print(f"Mirroring the in X axis: {int(flip < 0)}")
            print(f"Scale                  : {scale}")
            print(f"Translation (X,Y,Z)    : {x} {y} {z}")
            print(f"Rotation (rot,tilt,psi): {rot} {tilt} {psi}")
            print(f"Best grey scale       : {gs}")
            print(f"Best grey shift       : {gh}")
            print(f"Fitness value         : {best_fit}")
            print("xmipp_transform_geometry will require the following "
                  "values\n   Angles: %g %g %g\n   Shifts: %g %g %g"
                  % (rot, tilt, psi, A[0, 3], A[1, 3], A[2, 3]))
        if self.checkParam("--copyGeo") and self.getParam("--copyGeo"):
            with open(self.getParam("--copyGeo"), "w") as f:
                f.write("\n".join(f"{A[i, j]}" for i in range(4)
                                  for j in range(4)) + "\n")
        if self.checkParam("--copyGray") and self.getParam("--copyGray"):
            with open(self.getParam("--copyGray"), "w") as f:
                f.write(f"{gs}\n{gh}\n")
        if self.checkParam("--store") and self.getParam("--store"):
            with open(self.getParam("--store"), "w") as f:
                f.write(f"{rot}, {tilt}, {psi}, {A[0, 3]}, {A[1, 3]}, "
                        f"{A[2, 3]}, {best_fit}\n")
        if self.checkParam("--apply") and self.getParam("--apply"):
            from xmipp3_tpu_torch.ops.geo import apply_affine_3d
            out = apply_affine_3d(
                self._v2j, A[None, :3, :4].astype(np.float32),
                wrap=self.wrap)[0].cpu().numpy()
            out = out * gs + gh
            save_image(self.getParam("--apply"), out)


class ProgVolumeSubtraction(XmippProgram):
    name = "xmipp_volume_subtraction"

    def defineParams(self):
        self.addUsageLine("Adjust a volume to a reference by POCS iteration "
                          "and optionally subtract (reference "
                          "volume_subtraction.{h,cpp}: POCS amplitude/"
                          "minmax/mask/phase/nonneg projections per "
                          "iteration, runIteration at volume_subtraction."
                          "cpp:362-410).")
        self.addParamsLine("   --i1 <volume> : Reference volume")
        self.addParamsLine("   --i2 <volume> : Volume to modify")
        self.addParamsLine("  [-o <out=output_volume.mrc>] : Adjusted volume (or difference with --sub)")
        self.addParamsLine("  [--sub] : Output the subtraction instead")
        self.addParamsLine("  [--iter <n=5>] : Adjustment iterations")
        self.addParamsLine("  [--sigma <s=3>] : Smoothing decay of the subtraction mask transition")
        self.addParamsLine("  [--mask1 <m=\"\">] : Mask for volume 1")
        self.addParamsLine("  [--mask2 <m=\"\">] : Mask for volume 2")
        self.addParamsLine("  [--maskSub <m=\"\">] : Mask for the subtraction region")
        self.addParamsLine("  [--cutFreq <f=0>] : Low-pass both volumes at this digital frequency")
        self.addParamsLine("  [--lambda <l=1>] : Relaxation factor for the amplitude POCS")
        self.addParamsLine("  [--radavg] : Match radially averaged amplitudes instead of direct ones")
        self.addParamsLine("  [--saveV1 <f=\"\">] : Save the filtered reference (with --sub)")
        self.addParamsLine("  [--saveV2 <f=\"\">] : Save the adjusted volume (with --sub)")
        self.addParamsLine("  [--computeEnergy] : Print per-step convergence energy")

    def run(self):
        from xmipp3_tpu_torch.ops import pocs
        # the reference declares --computeEnergy and never reads it
        # (ROADMAP.md section 3, item 19)
        self.refuse_unread("--computeEnergy", item=19)
        dev = resolve_device(self.getParam("--device"))
        v1 = np.squeeze(Image(self.getParam("--i1")).data).astype(np.float32)
        v2 = np.squeeze(Image(self.getParam("--i2")).data).astype(np.float32)
        mask = None
        if self.getParam("--mask1") and self.getParam("--mask2"):
            m1 = np.squeeze(Image(self.getParam("--mask1")).data)
            m2 = np.squeeze(Image(self.getParam("--mask2")).data)
            mask = (m1 * m2).astype(np.float32)
        cut = float(self.getDoubleParam("--cutFreq"))
        with timed_phase("adjust"):
            adj = pocs.volume_adjust(
                v1, v2, mask=mask, iters=int(self.getIntParam("--iter")),
                lam=float(self.getDoubleParam("--lambda")),
                radavg=self.checkParam("--radavg"), cut_freq=cut,
                device=dev)
        if self.checkParam("--sub"):
            if self.getParam("--maskSub"):
                msub = np.squeeze(Image(self.getParam("--maskSub")).data)
            else:
                base = np.ones(v1.shape, np.float32) if mask is None else mask
                sigma = float(self.getIntParam("--sigma"))
                from scipy.ndimage import gaussian_filter
                msub = gaussian_filter(base, sigma)
            if self.getParam("--saveV2"):
                save_image(self.getParam("--saveV2"), adj.cpu().numpy())
            v1j = as_tensor(v1, dev)
            if self.getParam("--saveV1"):
                v1f = pocs.lowpass_volume(v1j, cut) if cut else v1j
                save_image(self.getParam("--saveV1"), v1f.cpu().numpy())
            with timed_phase("subtract"):
                out = pocs.subtract_adjusted(v1j, adj, msub.astype(
                    np.float32), cut)
        else:
            out = adj
        save_image(self.getParam("-o"), out.cpu().numpy())


class ProgVolumeSegment(XmippProgram):
    name = "xmipp_volume_segment"

    def defineParams(self):
        self.addUsageLine("Segment a volume into a binary mask.")
        self.addParamsLine("   -i <volume> : Input volume")
        self.addParamsLine("  [-o <mask=segmented.vol>] : Output binary mask")
        self.addParamsLine("  [--method <seg_method=otsu>] : Segmentation")
        self.addParamsLine("    where <seg_method>")
        self.addParamsLine("       voxel_mass <mass> : Keep the heaviest <mass> voxels")
        self.addParamsLine("       threshold <th>    : Absolute threshold")
        self.addParamsLine("       otsu              : Automatic (Otsu)")

    def run(self):
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        toks = self.getListParam("--method") or ["otsu"]
        if toks[0] == "threshold":
            th = float(toks[1])
        elif toks[0] == "voxel_mass":
            n_keep = int(float(toks[1]))
            th = np.partition(vol.ravel(), -n_keep)[-n_keep]
        else:  # otsu
            hist, edges = np.histogram(vol, bins=256)
            centers = 0.5 * (edges[:-1] + edges[1:])
            total = hist.sum()
            best, th = -1.0, centers[128]
            w0 = np.cumsum(hist)
            m0 = np.cumsum(hist * centers)
            mT = m0[-1]
            for k in range(1, 255):
                wb, wf = w0[k], total - w0[k]
                if wb == 0 or wf == 0:
                    continue
                mb = m0[k] / wb
                mf = (mT - m0[k]) / wf
                var = wb * wf * (mb - mf) ** 2
                if var > best:
                    best, th = var, centers[k]
        mask = (vol >= th).astype(np.float32)
        save_image(self.getParam("-o"), mask)
        self.threshold = float(th)
        if self.verbose:
            print(f"Threshold {th:.5f}: {int(mask.sum())} voxels")


class ProgTransformMask(XmippMetadataProgram):
    name = "xmipp_transform_mask"

    def defineProcessParams(self):
        self.addUsageLine("Apply a mask to images/volumes (reference ProgMask).")
        self.addParamsLine(" --mask <mask_type>  : Mask to apply")
        self.addParamsLine("    where <mask_type>")
        self.addParamsLine("       circular <R>  : Circle/sphere of radius R (R<0: dim/2+R)")
        self.addParamsLine("       crown <R1> <R2> : Ring between radii")
        self.addParamsLine("       gaussian <sigma> : Gaussian mask")
        self.addParamsLine("       rectangular <x> <y> <z=-1> : Box half-sizes")
        self.addParamsLine("       blob_circular <R> <W> : Kaiser-Bessel soft edge of width |W| past R (W<0: inner)")
        self.addParamsLine("       blob_crown <R1> <R2> <W> : Soft crown between radii")
        self.addParamsLine("       binary_file <file> : Mask image from file")
        self.addParamsLine("[-m <order=2>]  : Blob order for blob_* masks (reference mask.cpp:957)")
        self.addParamsLine("[-a <alpha=10.4>] : Blob alpha for blob_* masks")
        self.addParamsLine("[--substitute <v=0>] : Value outside the mask (number or min|max|avg)")
        self.addParamsLine("[--create_mask <out=\"\">] : Only write the mask image")
        self.addParamsLine("[--count_above <th=0>] : Count pixels within mask >= th")
        self.addParamsLine("[--count_below <th=0>] : Count pixels within mask <= th")

    def readProcessParams(self):
        self.mask_spec = self.getListParam("--mask")
        self.sub_str = self.getParam("--substitute") if \
            self.checkParam("--substitute") else "0"
        self.fn_create = self.getParam("--create_mask") if \
            self.checkParam("--create_mask") else ""
        self.count_above = self.getDoubleParam("--count_above") if \
            self.checkParam("--count_above") else None
        self.count_below = self.getDoubleParam("--count_below") if \
            self.checkParam("--count_below") else None

    def _sub_val(self, img):
        if self.sub_str == "min":
            return float(img.min())
        if self.sub_str == "max":
            return float(img.max())
        if self.sub_str == "avg":
            return float(img.mean())
        return float(self.sub_str)

    def _mask_for(self, shape):
        from xmipp3_tpu_torch.ops.mask import (blob_circular_mask,
                                               blob_crown_mask,
                                               circular_mask, crown_mask,
                                               gaussian_mask,
                                               rectangular_mask)
        t = self.mask_spec[0]
        a = self.mask_spec[1:]
        if t in ("blob_circular", "blob_crown"):
            order = self.getIntParam("-m") if self.checkParam("-m") else 2
            alpha = self.getDoubleParam("-a") if self.checkParam("-a") \
                else 10.4
            w = float(a[-1])
            if t == "blob_circular":
                return blob_circular_mask(shape, float(a[0]), abs(w),
                                          order, alpha, inner=w < 0)
            return blob_crown_mask(shape, float(a[0]), float(a[1]), abs(w),
                                   order, alpha, inner=w < 0)
        if t == "circular":
            return circular_mask(shape, abs(float(a[0])) if float(a[0]) > 0
                                 else float(a[0]))
        if t == "crown":
            return crown_mask(shape, float(a[0]), float(a[1]))
        if t == "gaussian":
            return gaussian_mask(shape, float(a[0]))
        if t == "rectangular":
            dims = [abs(int(float(v))) for v in a]
            return rectangular_mask(shape, dims[0], dims[1],
                                    dims[2] if len(dims) > 2 and
                                    len(shape) > 2 else None)
        if t == "binary_file":
            return np.squeeze(Image(a[0]).data).astype(np.float32)
        raise ValueError(t)

    def run(self):
        if self.fn_create:
            # mask-only mode: need dims from input
            img = Image()
            img.read(self.fn_in, header_only=True)
            n, z, y, x = img.header.shape
            shape = (z, y, x) if z > 1 else (y, x)
            save_image(self.fn_create, self._mask_for(shape))
            return
        super().run()

    def processBatch(self, imgs, rows):
        m = self._mask_for(imgs.shape[1:])
        if self.count_above is not None or self.count_below is not None:
            # reference ProgMask count mode (mask.cpp:1900-1936): report
            # per-image counts of in-mask values crossing the thresholds
            mb = m > 0.5
            elem = "voxels" if imgs.ndim == 4 else "pixels"
            for img, row in zip(imgs, rows):
                name = row.get("image", "")
                if self.count_above is not None and self.count_below is None:
                    n = int(np.count_nonzero(mb & (img >= self.count_above)))
                    print(f"{name} number of {elem} above "
                          f"{self.count_above} = {n}")
                elif self.count_below is not None and \
                        self.count_above is None:
                    n = int(np.count_nonzero(mb & (img <= self.count_below)))
                    print(f"{name} number of {elem} below "
                          f"{self.count_below} = {n}")
                else:
                    n = int(np.count_nonzero(
                        mb & (img >= self.count_above)
                        & (img <= self.count_below)))
                    print(f"{name} number of {elem} above "
                          f"{self.count_above} and below "
                          f"{self.count_below} = {n}")
                row["count"] = n
            return imgs
        I = as_tensor(imgs, self.device)
        mt = as_tensor(m, self.device)[None]
        if self.sub_str in ("min", "max", "avg"):
            flat = I.reshape(len(I), -1)
            val = {"min": lambda: flat.amin(dim=1),
                   "max": lambda: flat.amax(dim=1),
                   "avg": lambda: flat.mean(dim=1)}[self.sub_str]()
            val = val.reshape((-1,) + (1,) * (I.ndim - 1))
            return I * mt + val * (1.0 - mt)
        return I * mt + float(self.sub_str) * (1.0 - mt)


def _helical_symmetrize(vol, z_helical, rot_helical, rot_phase,
                        height_fraction, cn, dihedral=False):
    """symmetry_Helical (data/symmetries.cpp:1632-1705), vectorized: for
    every voxel average the volume sampled along the helical orbit
    (z + l*zHelical, theta + l*rotHelical) x Cn rotations, with the
    reference's edge weight ramp over half a helical rise."""
    from scipy.ndimage import map_coordinates

    D = vol.shape[0]
    half = round(height_fraction * D)
    z_first = -(half // 2)
    z_last = z_first + half - 1
    z_h2 = int(np.floor(0.5 * z_helical))
    cen = D // 2
    k, i, j = np.mgrid[0:D, 0:D, 0:D].astype(np.float64)
    k, i, j = k - cen, i - cen, j - cen
    rot = np.arctan2(i, j) + rot_phase
    rho = np.sqrt(i * i + j * j)
    l_len = int(np.ceil(D / z_helical))
    l0 = int(np.ceil((-cen - (D - 1 - cen)) / z_helical))
    acc = np.zeros_like(vol, np.float64)
    wsum = np.zeros_like(vol, np.float64)
    for il in range(l0, l0 + 2 * l_len + 1):
        kp = k + il * z_helical
        inside = (kp >= z_first) & (kp <= z_last)
        if not inside.any():
            continue
        w = np.ones_like(kp)
        w = np.where(kp - z_first <= z_h2,
                     (kp - z_first + 1) / (z_h2 + 1), w)
        w = np.where(z_last - kp <= z_h2, (z_last + 1 - kp) / (z_h2 + 1), w)
        w = np.where(inside, w, 0.0)
        rotp = rot + il * rot_helical
        ipb = rho * np.sin(rotp)
        jpb = rho * np.cos(rotp)
        variants = [(jpb, ipb, kp)]
        for n in range(1, cn):
            c, s = np.cos(2 * np.pi * n / cn), np.sin(2 * np.pi * n / cn)
            variants.append((c * jpb - s * ipb, s * jpb + c * ipb, kp))
        if dihedral:
            variants.append((jpb, -ipb, -kp))
        for jp, ip, kpp in variants:
            val = map_coordinates(vol, [kpp + cen, ip + cen, jp + cen],
                                  order=1, mode="constant")
            acc += w * val
            wsum += w
    return (acc / np.maximum(wsum, 1e-30)).astype(np.float32)


def _dihedral_symmetrize(vol):
    """symmetry_Dihedral (data/symmetries.cpp:1735-1773): find the best
    (rotZ, shiftZ) aligning the volume with its 180deg X-rotated copy,
    then average the two half-transformed copies."""
    from scipy.ndimage import affine_transform

    D = vol.shape[0]
    zmax = int(0.1 * D)

    def apply(v, deg, zshift, order=1):
        a = np.deg2rad(deg)
        # grid (z,y,x); rotation about z acts on (y,x)
        R = np.array([[1, 0, 0],
                      [0, np.cos(a), -np.sin(a)],
                      [0, np.sin(a), np.cos(a)]])
        c = np.array(v.shape) // 2
        Rinv = R.T
        off = c - Rinv @ (c + np.array([zshift, 0, 0]))
        return affine_transform(v, Rinv, offset=off, order=order,
                                mode="constant")

    x180 = vol[::-1, ::-1, :]  # 180deg about X: z->-z, y->-y
    best = (-np.inf, 0.0, 0.0)
    for rot in np.arange(-180.0, 180.0, 10.0):
        for z in np.arange(-zmax, zmax + 0.5, 1.0):
            cand = apply(vol, rot, z)
            c = np.corrcoef(cand.ravel(), x180.ravel())[0, 1]
            if c > best[0]:
                best = (c, rot, z)
    _, brot, bz = best
    # AZ(-r/2,-z/2)*AX == AX*AZ(r/2,z/2), so the symmetrized volume is
    # exactly the average of W and X180(W) with W the half-transformed map
    va = apply(vol, brot / 2, bz / 2, order=3)
    return (0.5 * (va + va[::-1, ::-1, :])).astype(np.float32)


class ProgTransformSymmetrize(XmippMetadataProgram):
    """Full reference surface symmetrize.cpp:62-215 +
    symmetrizeVolume/symmetrizeImage: point groups, helical /
    dihedral / helicalDihedral, mask_in, sum, dont_wrap, spline order."""
    name = "xmipp_transform_symmetrize"

    def defineProcessParams(self):
        self.addUsageLine("Symmetrize volumes and images.")
        self.addParamsLine("   --sym <symmetry> : 2D images: a number; 3D "
                           "volumes: point group (Cn/Dn/T/O/I...), symmetry "
                           "file, helical, dihedral or helicalDihedral")
        self.addParamsLine("  [--sym2 <sym2=C1>] : Cn symmetry for helical/"
                           "helicalDihedral")
        self.addParamsLine("  [--helixParams <z=1> <rot=0> <rotPhase=0>] : "
                           "Helical z (Angstroms), rot and rotPhase (deg)")
        self.addParamsLine("  [--heightFraction <f=0.95>] : Height fraction "
                           "used for symmetrizing a helix")
        self.addParamsLine("  [--sampling <T=1>] : Sampling rate (A/px), "
                           "only for helical parameters")
        self.addParamsLine("  [--no_group] : Do not generate the symmetry "
                           "subgroup")
        self.addParamsLine("  [--dont_wrap] : Fill outside values with the "
                           "outside average instead of wrapping")
        self.addParamsLine("  [--sum] : Sum instead of average (for "
                           "symmetrizing pieces)")
        self.addParamsLine("  [--mask_in <fileName=\"\">] : Symmetrize only "
                           "the masked area")
        self.addParamsLine("  [--spline <order=3>] : Interpolation spline "
                           "order (1 or 3)")

    def readProcessParams(self):
        self.sym = self.getParam("--sym")
        self.sym2 = self.getParam("--sym2")
        self.wrap = not self.checkParam("--dont_wrap")
        self.sum_mode = self.checkParam("--sum")
        self.spline = self.getIntParam("--spline")
        self.height_fraction = self.getDoubleParam("--heightFraction")
        self.mask_in = None
        if self.checkParam("--mask_in") and self.getParam("--mask_in"):
            self.mask_in = np.squeeze(
                Image(self.getParam("--mask_in")).data) > 0
        if self.sym in ("helical", "helicalDihedral"):
            Ts = self.getDoubleParam("--sampling")
            toks = self.getListParam("--helixParams")
            self.z_helical = float(toks[0]) / Ts
            self.rot_helical = np.deg2rad(float(toks[1]))
            self.rot_phase = np.deg2rad(float(toks[2])) if len(toks) > 2 \
                else 0.0
            self.cn = int(self.sym2[1:]) if len(self.sym2) > 1 else 1

    def run(self):
        # the reference never reads --no_group (ROADMAP.md section 3,
        # item 19)
        self.refuse_unread("--no_group", item=19)
        super().run()

    def _symmetrize_volume(self, v):
        from scipy.ndimage import affine_transform

        from xmipp3_tpu_torch.core.sym import SymList
        if self.sym == "helical":
            return _helical_symmetrize(v, self.z_helical, self.rot_helical,
                                       self.rot_phase, self.height_fraction,
                                       self.cn)
        if self.sym == "helicalDihedral":
            out = _helical_symmetrize(v, self.z_helical, self.rot_helical,
                                      self.rot_phase, self.height_fraction,
                                      self.cn, dihedral=True)
            rot = out[:, ::-1, ::-1]  # 180deg about X
            return (0.5 * (out + rot)).astype(np.float32)
        if self.sym == "dihedral":
            return _dihedral_symmetrize(v)
        mats = SymList(self.sym).sym_matrices()
        cval = 0.0
        if not self.wrap:
            # do_outside_avg: fill with the average outside the sphere
            D = min(v.shape)
            zz, yy, xx = np.mgrid[:v.shape[0], :v.shape[1], :v.shape[2]]
            c = np.array(v.shape) // 2
            outside = (np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 +
                               (xx - c[2]) ** 2) > D / 2)
            cval = float(v[outside].mean()) if outside.any() else 0.0
        acc = v.astype(np.float64).copy()
        vd = v.astype(np.float64)
        c = np.array(v.shape) // 2
        for M in mats:
            R = np.asarray(M, np.float64)
            if np.allclose(R, np.eye(3)):
                continue
            # matrices act on (x,y,z); the grid is (z,y,x)
            Rg = R[::-1, ::-1].T
            off = c - Rg @ c
            acc += affine_transform(vd, Rg, offset=off,
                                    order=min(self.spline, 3),
                                    mode="grid-wrap" if self.wrap
                                    else "constant", cval=cval)
        if not self.sum_mode:
            acc /= len(mats)
        out = acc.astype(np.float32)
        if self.mask_in is not None:
            out = np.where(self.mask_in, out, v)
        return out

    def processBatch(self, imgs, rows):
        if imgs.ndim == 3:
            # 2-D: every image's n - 1 rotations in one batch on the card,
            # summed in float64
            from xmipp3_tpu_torch.ops.geo import rotate_2d
            n = int(float(self.sym))
            I = as_tensor(imgs, self.device)
            acc = I.double()
            if n > 1:
                B, H, W = I.shape
                ang = np.tile(360.0 * np.arange(1, n) / n, B)
                rot = rotate_2d(I.repeat_interleave(n - 1, dim=0), ang)
                acc = acc + rot.double().reshape(B, n - 1, H, W).sum(1)
            return (acc if self.sum_mode else acc / max(n, 1)).float()
        out = np.empty_like(imgs)
        for i in range(len(imgs)):
            out[i] = self._symmetrize_volume(imgs[i])
        return out


def _pseudo_render_factory(shape, sigma, penalty, vol, valid, rng,
                           device=None):
    """The separable pseudo-atom renderer and its asymmetric loss on
    `device` (the card by default).

    The reference's per-atom drawGaussian loops
    (volume_to_pseudoatoms.cpp:604-631) become two float32 products: each
    isotropic Gaussian factors into rank-1 1-D profiles, so the cloud
    renders as `cz,cy->czy` then `czy,cx->zyx` (TF32 off). The gradients
    with respect to the positions and intensities come from
    torch.autograd through the same products (replacing the reference's
    8-trial coordinate descent, volume_to_pseudoatoms.cpp:755-830).
    """
    dev = resolve_device(device)
    D0, D1, D2 = shape
    axz = torch.arange(D0, dtype=torch.float32, device=dev)
    axy = torch.arange(D1, dtype=torch.float32, device=dev)
    axx = torch.arange(D2, dtype=torch.float32, device=dev)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    volj = as_tensor(vol, dev)
    validj = as_tensor(valid, dev)
    nvalid = torch.clamp_min(validj.sum(), 1.0)

    def render(pos, amp, alive):
        gz = torch.exp(-(axz[None] - pos[:, 0:1]) ** 2 * inv2s2)
        gy = torch.exp(-(axy[None] - pos[:, 1:2]) ** 2 * inv2s2)
        gx = torch.exp(-(axx[None] - pos[:, 2:3]) ** 2 * inv2s2)
        with fp32_products():
            czy = torch.einsum("cz,cy->czy", gz * (amp * alive)[:, None],
                               gy)
            return torch.einsum("czy,cx->zyx", czy, gx)

    def loss(pos, amp, alive):
        diff = render(pos, amp, alive) - volj
        vperc = torch.where(diff < 0, -diff, penalty * diff)
        return (vperc * validj).sum() / (nvalid * rng)

    def perc_err(pos, amp, alive):
        with torch.no_grad():
            diff = torch.abs(render(pos, amp, alive) - volj)
            return (diff * validj).sum() / (nvalid * rng)

    def opt_steps(pos, amp, alive, lr_pos, lr_amp, nsteps):
        """nsteps gradient steps on the card, with no host read; returns
        the positions, the intensities and the error after them. The
        backward products run in full float32 too."""
        with fp32_products():
            for _ in range(int(nsteps)):
                p = pos.detach().requires_grad_(True)
                a = amp.detach().requires_grad_(True)
                with torch.enable_grad():
                    gp, ga = torch.autograd.grad(loss(p, a, alive), (p, a))
                pos = p.detach() - lr_pos * gp
                amp = torch.clamp_min(a.detach() - lr_amp * ga, 0.0)
        return pos, amp, perc_err(pos, amp, alive)

    return render, perc_err, opt_steps


class ProgVolumeToPseudoatoms(XmippProgram):
    """Full reference surface volume_to_pseudoatoms.cpp:111-1020.

    The grow/optimize outer loop is kept
    (placeSeeds / removeSeeds / optimize until targetError,
    volume_to_pseudoatoms.cpp:966-1014) but the inner optimizer is a
    batched gradient descent on the same penalty-asymmetric objective
    (evaluateRegion, :694-701) over ALL atoms at once instead of the
    threaded per-atom 8-trial search; seeding is max-pool non-maximum
    suppression on the Gaussian-filtered difference volume (placeSeeds,
    :328-399) on the host. --thr, a thread count, changes nothing and
    stays accepted (ROADMAP.md section 3, item 19).
    """
    name = "xmipp_volume_to_pseudoatoms"

    def defineParams(self):
        self.addUsageLine("Approximate a volume with gaussian pseudoatoms "
                          "(seed growth + batched gradient refinement).")
        self.addParamsLine("   -i <volume>  : Input volume")
        self.addParamsLine("  [-o <root=\"\">] : Output rootname (.pdb); "
                           "default = input rootname")
        self.addParamsLine("  [--sigma <s=1.5>]  : Gaussian sigma "
                           "(Angstroms)")
        self.addParamsLine("  [--initialSeeds <N=300>] : Initial number of "
                           "pseudoatoms")
        self.addParamsLine("  [--growSeeds <percentage=30>] : Percentage of "
                           "growth; each iteration removes percentage/2 and "
                           "places percentage new seeds")
        self.addParamsLine("  [--stop <p=0.001>] : Stop criterion for inner "
                           "iterations (relative error decrease)")
        self.addParamsLine("  [--targetError <e=2>] : Finish when the "
                           "average representation error is below this "
                           "threshold (percentage)")
        self.addParamsLine("  [--dontAllowMovement] : Don't allow "
                           "pseudoatoms to move")
        self.addParamsLine("  [--dontAllowIntensity <f=0.01>] : Don't allow "
                           "intensity change; f = fraction of the intensity "
                           "range held by each pseudoatom")
        self.addParamsLine("  [--intensityColumn <s=Bfactor>] : PDB column "
                           "for the intensity (occupancy or Bfactor)")
        self.addParamsLine("  [--Nclosest <N=3>] : N closest atoms for the "
                           "distance histogram")
        self.addParamsLine("  [--minDistance <d=0.001>] : Minimum distance "
                           "between two pseudoatoms (Angstroms); -1 disables")
        self.addParamsLine("  [--penalty <p=10>] : Penalty for overshooting")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Sampling rate "
                           "(Angstroms/pixel)")
        self.addParamsLine("  [--sampling <Ts2=1>] : Alias of "
                           "--sampling_rate")
        self.addParamsLine("  [--dontScale] : Don't scale atom weights in "
                           "the PDB")
        self.addParamsLine("  [--binarize <threshold>] : Binarize the "
                           "volume for a more uniform distribution")
        self.addParamsLine("  [--thr <n=1>] : Number of threads (the "
                           "card's parallelism is automatic)")
        self.addParamsLine("  [--mask <binary_file=\"\">] : Restrict to a "
                           "binary mask volume")

    def run(self):
        from scipy.ndimage import gaussian_filter, maximum_filter

        dev = resolve_device(self.getParam("--device"))
        fn_in = self.getParam("-i")
        vol = np.squeeze(Image(fn_in).data).astype(np.float32)
        Ts = self.getDoubleParam("--sampling_rate") if \
            self.checkParam("--sampling_rate") else \
            self.getDoubleParam("--sampling")
        # produceSideInfo: sigma and minDistance are given in Angstroms
        sigma = self.getDoubleParam("--sigma") / Ts
        min_dist = self.getDoubleParam("--minDistance") / Ts
        penalty = self.getDoubleParam("--penalty")
        stop = self.getDoubleParam("--stop")
        target_error = self.getDoubleParam("--targetError") / 100.0
        initial_seeds = self.getIntParam("--initialSeeds")
        grow = self.getDoubleParam("--growSeeds")
        allow_movement = not self.checkParam("--dontAllowMovement")
        allow_intensity = not self.checkParam("--dontAllowIntensity")
        intensity_fraction = self.getDoubleParam("--dontAllowIntensity") \
            if not allow_intensity else 0.01
        col = self.getParam("--intensityColumn")
        if col not in ("occupancy", "Bfactor"):
            raise ValueError(f"Unknown column: {col}")
        n_closest = self.getIntParam("--Nclosest")
        dont_scale = self.checkParam("--dontScale")
        root = self.getParam("-o") if self.checkParam("-o") and \
            self.getParam("-o") else fn_in.rsplit(".", 1)[0]
        if self.checkParam("--binarize"):
            vol = (vol > self.getDoubleParam("--binarize")).astype(
                np.float32)
        mask = None
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data) > 0
        valid_region = (vol > 0) if mask is None else (vol > 0) & mask
        sel = vol[mask] if mask is not None else vol
        p1 = np.percentile(sel, 1)
        if p1 <= 0:
            p1 = sel.max() / 500.0
        rng = float(np.percentile(sel, 99) - p1)
        if rng == 0:
            raise ValueError("Range cannot be zero")
        small_atom = rng * intensity_fraction

        render, perc_err, opt_steps = _pseudo_render_factory(
            vol.shape, sigma, penalty, vol, valid_region, rng, dev)
        ones = lambda n: torch.ones(n, device=dev)

        pos = np.zeros((0, 3), np.float32)
        amp = np.zeros((0,), np.float32)

        def place_seeds(nseeds, current):
            """placeSeeds: NMS top-N on the Gaussian-filtered difference."""
            vdiff = gaussian_filter(vol - current, sigma)
            if mask is not None:
                vdiff = np.where(mask, vdiff, -np.inf)
            w = max(int(np.floor(sigma)), 1)
            local_max = vdiff >= maximum_filter(vdiff, size=2 * w + 1)
            cand = np.argwhere(local_max & np.isfinite(vdiff))
            vals = vdiff[tuple(cand.T)]
            order = np.argsort(-vals)[:nseeds]
            new_pos, new_amp = [], []
            for idx in order:
                v = float(vals[idx])
                if allow_intensity:
                    new_amp.append(v)
                else:
                    if v < small_atom:
                        break
                    new_amp.append(small_atom)
                new_pos.append(cand[idx])
            if not new_pos:
                return np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
            return (np.array(new_pos, np.float32),
                    np.array(new_amp, np.float32))

        def remove_seeds(nseeds, pos, amp, current):
            """removeSeeds: drop the smallest half + the half sitting on
            the most-negative filtered difference
            (volume_to_pseudoatoms.cpp:402-483)."""
            if nseeds <= 0 or len(amp) == 0:
                return pos, amp
            from_negative = int(round(nseeds * 0.5))
            from_small = nseeds - from_negative
            if not allow_intensity:
                from_negative, from_small = nseeds, 0
            keep = np.ones(len(amp), bool)
            if from_small > 0:
                keep[np.argsort(amp)[:from_small]] = False
            vdiff = gaussian_filter(vol - current, sigma)
            score = vdiff[tuple(np.round(pos).astype(int).clip(
                0, np.array(vol.shape) - 1).T)]
            order = np.argsort(score)
            removed = 0
            for i in order:
                if removed >= from_negative:
                    break
                if keep[i] and score[i] < 0:
                    keep[i] = False
                    removed += 1
            return pos[keep], amp[keep]

        def remove_too_close(pos, amp):
            """removeTooCloseSeeds (volume_to_pseudoatoms.cpp:486-553)."""
            if min_dist <= 0 or not allow_intensity or len(amp) < 2:
                return pos, amp
            keep = np.ones(len(amp), bool)
            d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
            md2 = min_dist * min_dist
            for i in range(len(amp)):
                if not keep[i]:
                    continue
                for j in range(i + 1, len(amp)):
                    if not keep[j] or d2[i, j] >= md2:
                        continue
                    if amp[i] < amp[j]:
                        keep[i] = False
                        break
                    keep[j] = False
            return pos[keep], amp[keep]

        def optimize(pos, amp):
            """optimizeCurrentAtoms as batched gradient descent on the
            penalty objective; stop on relative error stall."""
            if len(amp) == 0 or (not allow_movement and
                                 not allow_intensity):
                return pos, amp, float(perc_err(
                    as_tensor(pos.reshape(-1, 3), dev), as_tensor(amp, dev),
                    ones(max(len(amp), 1))))
            posj, ampj = as_tensor(pos, dev), as_tensor(amp, dev)
            alive = ones(len(amp))
            lr_pos = 0.1 * sigma if allow_movement else 0.0
            lr_amp = 0.05 * rng if allow_intensity else 0.0
            err = float(perc_err(posj, ampj, alive))
            for _ in range(40):
                # one host read a block of 10 steps, as the reference
                with timed_phase("optimize"):
                    posj, ampj, e = opt_steps(posj, ampj, alive, lr_pos,
                                              lr_amp, 10)
                    e = float(e)
                if err > 0 and (err - e) / err < stop:
                    err = min(err, e)
                    break
                err = e
            pos, amp = posj.cpu().numpy(), ampj.cpu().numpy()
            live = amp > 0
            return pos[live], amp[live], err

        def current_volume(pos, amp):
            if len(amp) == 0:
                return np.zeros_like(vol)
            with torch.no_grad():
                return render(as_tensor(pos, dev), as_tensor(amp, dev),
                              ones(len(amp))).cpu().numpy()

        perc_diff = 1.0
        prev_natoms = 0.0
        it = 0
        actual_grow = 0.0
        while True:
            cur = current_volume(pos, amp)
            if it == 0:
                npos, namp = place_seeds(initial_seeds, cur)
            else:
                natoms = len(amp)
                actual_grow = grow * min(
                    1.0, 0.1 + (perc_diff - target_error) / target_error)
                pos, amp = remove_seeds(
                    int(np.floor(natoms * (actual_grow / 2) / 100)),
                    pos, amp, cur)
                cur = current_volume(pos, amp)
                npos, namp = place_seeds(
                    int(np.floor(natoms * actual_grow / 100)), cur)
            pos = np.concatenate([pos, npos]).astype(np.float32)
            amp = np.concatenate([amp, namp]).astype(np.float32)
            pos, amp, perc_diff = optimize(pos, amp)
            pos, amp = remove_too_close(pos, amp)
            if self.verbose:
                print(f"Iteration {it} error= {perc_diff:.5f} "
                      f"Natoms= {len(amp)}")
            self._write_results(root, pos, amp, vol, sigma, Ts, col,
                                allow_intensity, dont_scale, n_closest,
                                current_volume, rng, mask)
            it += 1
            if perc_diff <= target_error:
                break
            if len(amp) == 0 or (
                    it > 1 and abs(prev_natoms - len(amp)) / len(amp)
                    < 0.01 * actual_grow / 100):
                if self.verbose:
                    print("The required precision cannot be attained\n"
                          "Suggestion: Reduce sigma and/or minDistance")
                break
            prev_natoms = len(amp)
        pos, amp = remove_too_close(pos, amp)
        self._write_results(root, pos, amp, vol, sigma, Ts, col,
                            allow_intensity, dont_scale, n_closest,
                            current_volume, rng, mask)
        self.n_placed = len(amp)
        self.final_error = perc_diff

    def _write_results(self, root, pos, amp, vol, sigma, Ts, col,
                       allow_intensity, dont_scale, n_closest,
                       current_volume, rng, mask):
        """writeResults (volume_to_pseudoatoms.cpp:885-963): PDB with the
        intensity in the chosen column; at -v 2 also the approximation
        volume, intensity/distance histograms and raw/relative diffs."""
        n = len(amp)
        mn = amp.min() if n else 0.0
        mx = amp.max() if n else 1.0
        a = 1.0 if dont_scale or mx == mn else 0.99 / (mx - mn)
        D = np.array(vol.shape)
        cen = D // 2
        with open(root + ".pdb", "w") as fh:
            fh.write("REMARK xmipp_volume_to_pseudoatoms\n")
            fh.write(f"REMARK fixedGaussian {sigma * Ts:f}\n")
            fh.write(f"REMARK intensityColumn {col}\n")
            for i in range(n):
                inten = 1.0
                if allow_intensity:
                    inten = 0.01 + round(100 * a * (amp[i] - mn)) / 100.0
                x = (pos[i, 2] - cen[2]) * Ts
                y = (pos[i, 1] - cen[1]) * Ts
                z = (pos[i, 0] - cen[0]) * Ts
                if col == "occupancy":
                    fh.write(f"ATOM  {i+1:5d} DENS DENS{i+1:5d}    "
                             f"{x:8.3f}{y:8.3f}{z:8.3f}{inten:6.2f}"
                             f"     1      DENS\n")
                else:
                    fh.write(f"ATOM  {i+1:5d} DENS DENS{i+1:5d}    "
                             f"{x:8.3f}{y:8.3f}{z:8.3f}     1"
                             f"{inten:6.2f}      DENS\n")
        if self.verbose >= 2 and n:
            cur = current_volume(pos, amp)
            save_image(root + "_approximation.vol", cur.astype(np.float32))
            counts, edges = np.histogram(amp, bins=100, range=(0, amp.max()))
            with open(root + "_approximation.hist", "w") as fh:
                for c, e in zip(counts, edges):
                    fh.write(f"{e:g} {c}\n")
            vdiff = vol - cur
            if mask is not None:
                vdiff = np.where(mask, vdiff, 0.0)
            save_image(root + "_rawDiff.vol", vdiff.astype(np.float32))
            save_image(root + "_relativeDiff.vol",
                       (vdiff / rng).astype(np.float32))
            if n > 1:
                d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1)) * Ts
                np.fill_diagonal(d, np.inf)
                k = min(n_closest, n - 1)
                dists = np.sort(d, axis=1)[:, :k].ravel()
                counts, edges = np.histogram(dists, bins=200)
                with open(root + "_distance.hist", "w") as fh:
                    for c, e in zip(counts, edges):
                        fh.write(f"{e:g} {c}\n")


PROGRAM = None
