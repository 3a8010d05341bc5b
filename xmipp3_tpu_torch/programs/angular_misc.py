"""More angular programs: assignment_mag, discrete_assign,
break_symmetry, estimate_tilt_axis, multireference_aligneability,
validation_nontilt, compare_views.

Contracts: the reference package's programs/angular_misc.py (reference
angular_assignment_mag (angular_assignment_mag.h:49),
angular_discrete_assign, angular_break_symmetry,
angular_estimate_tilt_axis, multireference_aligneability,
validation_nontilt, compare_views). The two assignment programs are the
matching program on the card with a gallery of their own or a candidate
mask; multireference_aligneability scores every image against its
--sampling gallery with K4 (ops/match.py::rotational_corr_matrix) in chunks
of images, which give the numbers one call would; the orientation
statistics stay host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.programs.angular_projection_matching import \
    ProgAngularProjectionMatching


class ProgAngularDiscreteAssign(ProgAngularProjectionMatching):
    """Discrete angular assignment in WAVELET space (reference
    angular_discrete_assign.h:41: DWT feature matching with coarse-to-fine
    selection). A db4 low-band correlation over the WHOLE gallery (one
    matrix product on 16x-smaller coefficients, on the card) selects the
    top-M candidate orientations per image; the shared ring-FFT engine
    then resolves (psi, shift) only inside that candidate set — the
    multiscale discrete selection of the reference with the dense
    refinement of the matching engine."""
    name = "xmipp_angular_discrete_assign"

    _ll_cache = None

    def defineParams(self):
        super().defineParams()
        # reference grammar: angular_discrete_assign.cpp defineParams
        self.addParamsLine("  [--sym <symmetry=\"\">] : Symmetry group "
                           "(used by the rot-tilt restriction)")
        self.addParamsLine("  [--max_shift_change <r=0>] : Maximum change "
                           "allowed in shift (0 = use --max_shift)")
        self.addParamsLine("  [--psi_step <ang=5>] : Step in psi (deg) of "
                           "the coarse in-plane search")
        self.addParamsLine("  [--shift_step <r=1>] : Step in shift (px) of "
                           "the translation grid")
        self.addParamsLine("  [--search5D]        : Joint 5D search (the "
                           "engine always searches (ref, psi, shift) "
                           "jointly; accepted for grammar parity)")
        self.addParamsLine("  [--dont_check_mirrors] : Do not check "
                           "mirrors of the input images")
        self.addParamsLine("  [--max_proj_change <ang=-1>] : Maximum "
                           "change allowed in rot-tilt")
        self.addParamsLine("  [--max_psi_change <ang=-1>] : Maximum change "
                           "allowed in psi")
        self.addParamsLine("  [--keep <th=50>]    : Percentage of gallery "
                           "candidates kept by the wavelet preselection")
        self.addParamsLine("  [--smin <s=1>]      : Finest DWT scale used")
        self.addParamsLine("  [--smax <s=-1>]     : Coarsest DWT scale "
                           "used (-1 = 2 levels)")
        self.addParamsLine("  [--pick <mth=1>]    : 0 = best-correlation "
                           "candidate set; 1 = most populated direction "
                           "cluster among the candidates")
        self.addParamsLine("  [--show_rot_tilt]   : Show the rot-tilt "
                           "preselection")
        self.addParamsLine("  [--show_psi_shift]  : Show the psi-shift "
                           "resolution")
        self.addParamsLine("  [--show_options]    : Show the final "
                           "candidate options")

    def readParams(self):
        super().readParams()
        if self.checkParam("--sym") and self.getParam("--sym"):
            from xmipp3_tpu_torch.core.sym import SymList
            self.sym = SymList(self.getParam("--sym"))
        msc = self.getDoubleParam("--max_shift_change")
        if msc > 0:
            self.max_shift = int(round(msc))
        self.psi_step = self.getDoubleParam("--psi_step")
        self.trial_step = self.getDoubleParam("--shift_step")
        if self.checkParam("--dont_check_mirrors"):
            self.check_mirror = False
        mpc = self.getDoubleParam("--max_proj_change")
        if mpc >= 0:
            self.max_ang_change = mpc
        mpsi = self.getDoubleParam("--max_psi_change")
        self.max_psi_change = mpsi if mpsi >= 0 else None
        self.keep_pct = self.getDoubleParam("--keep")
        self.smin = self.getIntParam("--smin")
        self.smax = self.getIntParam("--smax")
        self.pick = self.getIntParam("--pick")
        self.show_rot_tilt = self.checkParam("--show_rot_tilt")
        self.show_psi_shift = self.checkParam("--show_psi_shift")
        self.show_options = self.checkParam("--show_options")
        self.refuse_unread("--show_psi_shift", item=13)

    def _dwt_levels(self, H):
        """--smin/--smax -> number of db4 decomposition levels: the
        coarsest scale bounds the pyramid depth (reference smax; -1 keeps
        the 2-level default), clamped so the low band stays >= 8 px."""
        import math
        levels = self.smax if self.smax > 0 else 2
        return int(max(1, min(levels, math.floor(math.log2(H)) - 3)))

    @staticmethod
    def _low_band(x, levels):
        """Zero-mean, unit-norm db4 low bands of a (B, H, W) tensor, (B, L)."""
        from xmipp3_tpu_torch.ops.denoise import db4_dwt2
        ll, _ = db4_dwt2(x, levels)
        ll = ll.reshape(len(x), -1)
        ll = ll - ll.mean(dim=1, keepdim=True)
        return ll / torch.linalg.norm(ll, dim=1, keepdim=True).clamp(
            min=1e-9)

    def _extra_allowed(self, imgs, refs):
        levels = self._dwt_levels(refs.shape[-1])
        if self._ll_cache is None or self._ll_cache[0] is not refs:
            self._ll_cache = (refs, self._low_band(refs, levels))
        ll_r = self._ll_cache[1]
        ll_i = self._low_band(torch.as_tensor(imgs, device=refs.device),
                              levels)
        cc = (ll_i @ ll_r.T).cpu().numpy()       # (B, R) low-band NCC
        R = len(ll_r)
        # --keep is the PER-ROUND retention of the reference's
        # coarse-to-fine scale sweep; the single-pass equivalent keeps
        # (keep/100)^levels of the gallery (50% over 2 rounds = 25%)
        keep = getattr(self, "keep_pct", 50.0)
        frac = (keep / 100.0) ** levels
        m = int(np.clip(round(R * frac), min(8, R), R))
        thresh = np.sort(cc, axis=1)[:, -m][:, None]
        mask = (cc >= thresh).astype(np.float32)
        if getattr(self, "pick", 1) == 1 and self._ref_dirs_all is not None:
            mask = self._pick_populated(mask, cc)
        if getattr(self, "show_rot_tilt", False):
            for i in range(len(mask)):
                print(f"  image {i}: {int(mask[i].sum())} rot-tilt "
                      f"candidates kept")
        return mask

    def _pick_populated(self, mask, cc):
        """--pick 1: among the wavelet-preselected candidates keep only
        the most populated projection-direction cluster (reference 'maximum
        of the most populated' group selection). The clustering radius
        adapts to the gallery's nearest-neighbor separation; size ties
        break toward the cluster holding the best correlation."""
        dirs = self._ref_dirs_all
        # nearest-neighbor angular separation of the gallery
        cosg = np.clip(np.abs(dirs @ dirs.T), -1.0, 1.0)
        np.fill_diagonal(cosg, -1.0)
        nn_sep = np.degrees(np.arccos(np.median(cosg.max(axis=1))))
        cos_thr = np.cos(np.deg2rad(max(15.0, 1.6 * nn_sep)))
        out = np.array(mask)
        for i in range(len(mask)):
            cand = np.flatnonzero(mask[i] > 0)
            if len(cand) <= 1:
                continue
            # the reference picks among a SHORT final-options list (the
            # per-scale winners); cluster only the best few candidates
            if len(cand) > 8:
                cand = cand[np.argsort(cc[i, cand])[-8:]]
            d = dirs[cand]
            adj = np.abs(d @ d.T) >= cos_thr
            # connected components (greedy BFS)
            comp = -np.ones(len(cand), int)
            c = 0
            for s in range(len(cand)):
                if comp[s] >= 0:
                    continue
                stack = [s]
                comp[s] = c
                while stack:
                    u = stack.pop()
                    for v in np.flatnonzero(adj[u]):
                        if comp[v] < 0:
                            comp[v] = c
                            stack.append(v)
                c += 1
            sizes = np.bincount(comp)
            # score: population first, best candidate correlation second
            cc_i = cc[i, cand]
            best_cc = np.array([cc_i[comp == k].max()
                                for k in range(c)])
            best = np.lexsort((best_cc, sizes))[-1]
            keep = cand[comp == best]
            out[i] = 0.0
            out[i, keep] = 1.0
            if getattr(self, "show_options", False):
                print(f"  image {i}: cluster sizes {sizes.tolist()}, "
                      f"kept {len(keep)}")
        return out


class ProgAngularAssignmentMag(ProgAngularProjectionMatching):
    """Fast assignment via Fourier-magnitude rotation estimation
    (reference angular_assignment_mag.h:49). The gallery path shares the
    matching engine; the magnitude trick lives in ops.align and is used by
    the in-plane stage. Accepts the reference's single-dash spellings
    (-ref/-odir/-sampling/-angleStep, angular_assignment_mag.cpp grammar)
    and its validation extras."""
    name = "xmipp_angular_assignment_mag"

    def defineParams(self):
        super().defineParams()
        g = self._grammar
        # reference single-dash spellings -> the matching grammar
        g._alias_map["-ref"] = "--ref"
        g.params["--ref"].aliases.append("-ref")
        g._alias_map["--maxShift"] = "--max_shift"
        g.params["--max_shift"].aliases.append("--maxShift")
        self.addParamsLine("  [-odir <outputDir=\".\">] : Output directory")
        self.addParamsLine("  [--sym <symfile=c1>] : Enforce symmetry in "
                           "the assigned projections")
        self.addParamsLine("  [-sampling <sampling=1.>] : Pixel size (A)")
        self.addParamsLine("  [-angleStep <angStep=3.>] : Gallery angular "
                           "step when reprojecting --refVol")
        self.addParamsLine("  [--refVol <refVolFile=NULL>] : Reference "
                           "volume reprojected as the gallery (instead of "
                           "--ref projections)")
        self.addParamsLine("  [--useForValidation] : Keep the per-image "
                           "neighborhood candidate list for the "
                           "multireference aligneability validation")

    def readParams(self):
        super().readParams()
        self.refuse_unread("-sampling", "--useForValidation", item=13)

    def read(self, argv):
        # --refVol: reproject the volume at -angleStep into a gallery so
        # the base matcher can run unchanged (the reference builds its
        # own gallery internally in this mode)
        argv = list(argv)
        if "--refVol" in argv and not any(
                t in argv for t in ("--ref", "-r", "-ref")):
            import os
            import tempfile
            from xmipp3_tpu_torch.core.sampling import compute_sampling_points
            from xmipp3_tpu_torch.ops.project import FourierProjector

            def _val(flag, default):
                return (argv[argv.index(flag) + 1] if flag in argv
                        and argv.index(flag) + 1 < len(argv) else default)
            vol = np.squeeze(Image(_val("--refVol", "")).data
                             ).astype(np.float32)
            step = float(_val("-angleStep", "3.0"))
            angles = compute_sampling_points(step)
            dev = resolve_device(_val("--device", None))
            proj = FourierProjector(vol, device=dev).project_euler(
                angles[:, 0].astype(np.float32),
                angles[:, 1].astype(np.float32),
                np.zeros(len(angles), np.float32)).cpu().numpy()
            odir = _val("-odir", ".")
            os.makedirs(odir or ".", exist_ok=True)
            d = tempfile.mkdtemp(dir=odir or ".")
            save_image(os.path.join(d, "gal.stk"), proj)
            MetaData.fromRows([
                {"image": f"{k + 1:06d}@{os.path.join(d, 'gal.stk')}",
                 "angleRot": float(angles[k, 0]),
                 "angleTilt": float(angles[k, 1]), "anglePsi": 0.0}
                for k in range(len(angles))]).write(
                os.path.join(d, "gal.doc"))
            argv = argv + ["--ref", os.path.join(d, "gal.doc")]
        super().read(argv)


class ProgAngularBreakSymmetry(XmippProgram):
    name = "xmipp_angular_break_symmetry"

    def defineParams(self):
        self.addUsageLine("Randomly reassign each image's angles among its "
                          "symmetry-equivalent versions (break symmetry).")
        self.addParamsLine("   -i <md_file>  : Input angles")
        self.addParamsLine("   -o <md_file>  : Output angles")
        self.addParamsLine("  [--sym <s=c1>] : Symmetry group")
        self.addParamsLine("  [--seed <n=0>] : Random seed")

    def run(self):
        from xmipp3_tpu_torch.core.sym import SymList
        md = MetaData(self.getParam("-i"))
        sym = SymList(self.getParam("--sym"))
        rng = np.random.default_rng(self.getIntParam("--seed"))
        rows = []
        for i in md:
            r = md.getRow(i)
            equiv = sym.expand_euler(float(r.get("angleRot", 0)),
                                     float(r.get("angleTilt", 0)),
                                     float(r.get("anglePsi", 0)))
            rot, tilt, psi = equiv[rng.integers(0, len(equiv))]
            r["angleRot"], r["angleTilt"], r["anglePsi"] = rot, tilt, psi
            rows.append(r)
        MetaData.fromRows(rows).write(self.getParam("-o"))


class ProgAngularEstimateTiltAxis(XmippProgram):
    name = "xmipp_angular_estimate_tilt_axis"

    def defineParams(self):
        self.addUsageLine("Estimate the tilt axis direction from matching "
                          "untilted/tilted coordinate pairs.")
        self.addParamsLine("   --untilted <md> : Untilted coordinates (xcoor/ycoor)")
        self.addParamsLine("   --tilted <md>   : Tilted coordinates")
        self.addParamsLine("  [-o <md=\"\">]     : Output metadata")

    def run(self):
        md_u = MetaData(self.getParam("--untilted"))
        md_t = MetaData(self.getParam("--tilted"))
        u = np.stack([md_u.getColumn("xcoor").astype(float),
                      md_u.getColumn("ycoor").astype(float)], axis=1)
        t = np.stack([md_t.getColumn("xcoor").astype(float),
                      md_t.getColumn("ycoor").astype(float)], axis=1)
        n = min(len(u), len(t))
        u, t = u[:n], t[:n]
        # affine fit t = A u + b; tilt axis = eigenvector of A with |lam|=1
        U = np.hstack([u, np.ones((n, 1))])
        A, *_ = np.linalg.lstsq(U, t, rcond=None)
        M = A[:2].T                     # 2x2 linear part
        # direction preserved in length: M^T M eigenvector with eigenvalue ~1
        w, v = np.linalg.eigh(M.T @ M)
        axis = v[:, np.argmin(np.abs(w - 1.0))]
        ang = float(np.degrees(np.arctan2(axis[1], axis[0])))
        cos_tilt = np.sqrt(np.clip(w.min(), 0, 1))
        tilt = float(np.degrees(np.arccos(np.clip(cos_tilt, -1, 1))))
        self.tilt_axis_angle = ang
        self.tilt_angle = tilt
        print(f"Tilt axis angle: {ang:.2f} deg; tilt: {tilt:.2f} deg")
        if self.checkParam("-o") and self.getParam("-o"):
            MetaData.fromRows([{"tiltAxisAngle": ang, "angleY": tilt}]
                              ).write(self.getParam("-o"))


def _projdir_distance_matrix(angles1, angles2, sym_mats, check_mirrors):
    """Pairwise minimal projection-direction distances (degrees) between
    two orientation sets under a symmetry list — the vectorized form of
    SymList::computeDistance(projdir_mode=true) used by the alignability
    scores (multireference_aligneability.cpp:278-313)."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    d1 = np.asarray(euler_matrix(angles1[:, 0], angles1[:, 1],
                                 angles1[:, 2]))[..., 2, :]   # (N,3)
    d2 = np.asarray(euler_matrix(angles2[:, 0], angles2[:, 1],
                                 angles2[:, 2]))[..., 2, :]   # (M,3)
    best = None
    for L in np.asarray(sym_mats, np.float64):
        d2e = d2 @ L.T
        dots = d1 @ d2e.T
        if check_mirrors:
            dots = np.abs(dots)
        ang = np.degrees(np.arccos(np.clip(dots, -1.0, 1.0)))
        best = ang if best is None else np.minimum(best, ang)
    return best


def gallery_correlations(refs, imgs, chunk: int = 512):
    """The best in-plane correlation of every image with every gallery
    image, (B, R) on the host: ring spectra of both (radius 2 to H/2 - 2)
    and K4 without the mirror (ops/match.py::rotational_corr_matrix), over
    the images in chunks of `chunk`. K4 sums each (b, R, k) in a fixed
    order, so the chunks give the numbers one call would."""
    from xmipp3_tpu_torch.ops.match import rotational_corr_matrix
    from xmipp3_tpu_torch.ops.polar import cartesian_to_polar, ring_ffts
    H = refs.shape[-1]
    f_refs = ring_ffts(cartesian_to_polar(refs, 2, H // 2 - 2))
    out = []
    for s in range(0, len(imgs), chunk):
        x = torch.as_tensor(imgs[s:s + chunk], device=refs.device)
        f_imgs = ring_ffts(cartesian_to_polar(x, 2, H // 2 - 2))
        out.append(rotational_corr_matrix(f_refs, f_imgs, 2).amax(dim=2)
                   .cpu().numpy())
    return np.concatenate(out)


class ProgMultireferenceAligneability(XmippProgram):
    """Full reference surface (multireference_aligneability.cpp:43-571):
    per-particle alignability precision (clusteredness of the Significant
    orientations vs the same for reference projections, baselined by the
    random-gallery noise expectation) and accuracy (weighted distance of
    the assigned pose to the Significant cloud), with --check_mirrors /
    --dontUseWeights / --sym, writing pruned_particles_alignability.xmd
    and validationAlignability.xmd into --odir.  The pairwise angular
    distances are evaluated as vectorized direction-matrix products."""
    name = "xmipp_multireference_aligneability"

    # images a K4 launch of the simple engine takes
    chunk = 512

    def defineParams(self):
        self.addUsageLine("Alignability validation: precision/accuracy of "
                          "each particle's angular assignment against a "
                          "reference volume gallery.")
        self.addParamsLine("  [-i <md_file=\"\">]  : Particles with poses")
        self.addParamsLine("  [-i2 <md_file=\"\">] : Reference particles "
                           "(volume projections at the same orientations)")
        self.addParamsLine("  [--volume <vol=\"\">] : Reference volume")
        self.addParamsLine("  [-o <md_file=\"\">]  : Output with "
                           "alignability scores (simple engine)")
        self.addParamsLine("  [--sampling <s=15>] : Gallery sampling (deg)")
        self.addParamsLine("  [--angles_file <f=.>] : Significant "
                           "orientations of the experimental particles")
        self.addParamsLine("  [--angles_file_ref <f=.>] : Significant "
                           "orientations of the reference projections")
        self.addParamsLine("  [--gallery <f=.>]   : Reference projection "
                           "gallery metadata")
        self.addParamsLine("  [--sym <s=c1>]      : Symmetry")
        self.addParamsLine("  [--odir <d=.>]      : Output directory")
        self.addParamsLine("  [--check_mirrors]   : Axis-without-direction "
                           "distances (mirror-aware)")
        self.addParamsLine("  [--dontUseWeights]  : Unweighted "
                           "clusterability")

    @staticmethod
    def _angles_w(rows):
        ang = np.array([[float(r.get("angleRot", 0.0)),
                         float(r.get("angleTilt", 0.0)),
                         float(r.get("anglePsi", 0.0))] for r in rows])
        w = np.array([float(r.get("maxCC", 1.0) or 1.0) for r in rows])
        return ang, w

    def _sumu(self, rows, sym_mats, check_mirrors, use_weights):
        ang, w = self._angles_w(rows)
        D = _projdir_distance_matrix(ang, ang, sym_mats, check_mirrors)
        if use_weights:
            WW = np.outer(w, w)
        else:
            WW = np.ones_like(D)
        return float((D * WW).sum() / max(WW.sum(), 1e-12))

    def _noise(self, num, gallery_rows, sym_mats, check_mirrors,
               trials=100):
        ang, _ = self._angles_w(gallery_rows)
        rng = np.random.default_rng(0)
        tot = 0.0
        for _ in range(trials):
            idx = rng.choice(len(ang), size=min(num, len(ang)),
                             replace=False)
            D = _projdir_distance_matrix(ang[idx], ang[idx], sym_mats,
                                         check_mirrors)
            tot += D.sum()
        n = min(num, len(ang))
        return tot / (trials * max(n - 1, 1) ** 2)

    def _accuracy(self, rows, ref_row, sym_mats, check_mirrors):
        ang, w = self._angles_w(rows)
        ref = np.array([[float(ref_row.get("angleRot", 0.0)),
                         float(ref_row.get("angleTilt", 0.0)),
                         float(ref_row.get("anglePsi", 0.0))]])
        acc = float((_projdir_distance_matrix(ref, ang, sym_mats,
                                              check_mirrors)[0] * w).sum()
                    / max(w.sum(), 1e-12))
        acc_mirror = float((_projdir_distance_matrix(
            ref, ang, sym_mats, True)[0] * w).sum() / max(w.sum(), 1e-12))
        return acc, acc_mirror

    def _run_reference(self):
        import os
        from xmipp3_tpu_torch.core.sym import SymList
        odir = self.getParam("--odir")
        sym = SymList(self.getParam("--sym"))
        mats = sym.sym_matrices()
        chk = self.checkParam("--check_mirrors")
        use_w = not self.checkParam("--dontUseWeights")
        md_exp = MetaData(self.getParam("--angles_file"))
        md_ref = MetaData(self.getParam("--angles_file_ref"))
        md_gal = MetaData(self.getParam("--gallery"))
        md_parts = MetaData(self.getParam("-i"))
        parts = list(md_parts.iterRows())
        gal_rows = list(md_gal.iterRows())
        by_idx_exp, by_idx_ref = {}, {}
        for r in md_exp.iterRows():
            by_idx_exp.setdefault(int(r.get("imageIndex", 0)), []).append(r)
        for r in md_ref.iterRows():
            by_idx_ref.setdefault(int(r.get("imageIndex", 0)), []).append(r)
        max_idx = max(by_idx_exp) if by_idx_exp else -1
        num_projs = len(by_idx_exp.get(max_idx, []))
        noise = self._noise(num_projs, gal_rows, mats, chk)
        out_rows = []
        for i in range(max_idx + 1):
            exp = by_idx_exp.get(i, [])
            ref = by_idx_ref.get(i, [])
            if not exp or not ref or i >= len(parts):
                continue
            sum_w_exp = self._sumu(exp, mats, chk, use_w)
            sum_w_ref = self._sumu(ref, mats, chk, use_w)
            acc, acc_m = self._accuracy(exp, parts[i], mats, chk)
            acc_r, acc_mr = self._accuracy(ref, parts[i], mats, chk)
            d = dict(parts[i])
            d["image"] = str(exp[0].get("image", d.get("image", "")))
            d["imageIndex"] = i
            def ratio(num, den):
                # the reference divides signed deviations directly
                # (multireference_aligneability.cpp:175-177)
                if abs(den) < 1e-12:
                    den = 1e-12
                return num / den

            d["scoreByAlignabilityPrecision"] = ratio(sum_w_exp - noise,
                                                      sum_w_ref - noise)
            d["scoreByAlignabilityAccuracy"] = ratio(acc - noise,
                                                     acc_r - noise)
            d["scoreByMirror"] = ratio(acc_m - noise, acc_mr - noise)
            d["scoreByAlignabilityPrecisionExp"] = sum_w_exp
            d["scoreByAlignabilityPrecisionRef"] = sum_w_ref
            d["scoreByAlignabilityAccuracyExp"] = acc
            d["scoreByAlignabilityAccuracyRef"] = acc_r
            d["scoreByAlignabilityNoise"] = noise
            out_rows.append(d)
        MetaData.fromRows(out_rows).write(
            os.path.join(odir, "pruned_particles_alignability.xmd"))
        prec = np.array([r["scoreByAlignabilityPrecision"]
                         for r in out_rows])
        acc = np.array([r["scoreByAlignabilityAccuracy"]
                        for r in out_rows])
        mirr = np.array([r["scoreByMirror"] for r in out_rows])
        n = max(max_idx + 1, 1)
        summary = {"image": self.getParam("--volume") or "validation",
                   "weightAlignabilityPrecision":
                       float((prec > 0.5).sum()) / n,
                   "weightAlignabilityAccuracy":
                       float((acc > 0.5).sum()) / n,
                   "weightAlignability":
                       float(((acc > 0.5) & (prec > 0.5)).sum()) / n,
                   "weightMirrorPrecision":
                       float((mirr > 0.5).sum()) / n}
        MetaData.fromRows([summary]).write(
            os.path.join(odir, "validationAlignability.xmd"))
        self.summary = summary
        self.precision = prec
        self.accuracy = acc

    def run(self):
        self.refuse_unread("-i2", item=13)
        if self.checkParam("--angles_file") and \
                self.getParam("--angles_file") not in ("", "."):
            self._run_reference()
            return
        from xmipp3_tpu_torch.core.sampling import (Sampling,
                                                    directions_from_angles)
        from xmipp3_tpu_torch.ops.project import FourierProjector
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        with timed_phase("read images"):
            imgs = load_image_rows(rows)
        vol = np.squeeze(Image(self.getParam("--volume")).data
                         ).astype(np.float32)
        s = Sampling(self.getDoubleParam("--sampling"), "c1")
        with timed_phase("gallery"):
            refs = FourierProjector(vol, device=dev).project_euler(
                s.angles[:, 0].astype(np.float32),
                s.angles[:, 1].astype(np.float32),
                np.zeros(len(s.angles), np.float32))
        with timed_phase("score", sync=refs):
            corr = gallery_correlations(refs, imgs, self.chunk)  # (B, R)
        best = corr.argmax(axis=1)
        d_ref = s.directions
        d_ass = directions_from_angles(np.stack(
            [np.array([float(r.get("angleRot", 0)) for r in rows]),
             np.array([float(r.get("angleTilt", 0)) for r in rows])], axis=1))
        # precision: sharpness of the correlation landscape;
        # accuracy: distance between claimed pose and gallery-best pose
        sorted_corr = np.sort(corr, axis=1)
        precision = (sorted_corr[:, -1] - sorted_corr[:, -5]) / \
            np.maximum(np.abs(sorted_corr[:, -1]), 1e-9)
        acc_ang = np.degrees(np.arccos(np.clip(
            (d_ass * d_ref[best]).sum(1), -1, 1)))
        accuracy = np.minimum(acc_ang, 180 - acc_ang)
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["weightAlignabilityPrecision"] = float(precision[i])
            d["weightAlignabilityAccuracy"] = float(
                np.exp(-accuracy[i] / 30.0))
            out.append(d)
        MetaData.fromRows(out).write(self.getParam("-o"))
        self.precision = precision
        self.accuracy = accuracy


class ProgValidationNonTilt(ProgMultireferenceAligneability):
    """Full reference surface (validation_nontilt.cpp:40-470): per-particle
    clustering-tendency statistic P — the Hopkins-like ratio of the
    weighted nearest-neighbour distance sum of the particle's assigned
    orientation cloud (H) against the same statistic for random clouds
    sampled from the gallery (H0) — written to odir/clusteringTendency.xmd
    with the volume-level fraction P>1 in odir/validation.xmd.  The
    nearest-neighbour sums for all random trials are evaluated in one
    batched einsum instead of the reference's per-trial loops."""
    name = "xmipp_validation_nontilt"

    def defineParams(self):
        super().defineParams()
        self.addParamsLine("  [--i <md=\"\">] : Metadata with input "
                           "projections (reference spelling)")
        self.addParamsLine("  [--significance_noise <s=0.95>] : "
                           "Significance of the alignment vs noise")
        self.addParamsLine("  [--useSignificant] : Orientation clouds are "
                           "grouped by imageIndex (Significant output) "
                           "instead of itemId")

    @staticmethod
    def _dirs_w(rows):
        rot = np.array([float(r.get("angleRot", 0.0)) for r in rows])
        tilt = np.array([float(r.get("angleTilt", 0.0)) for r in rows])
        flip = np.array([bool(r.get("flip", 0)) for r in rows])
        tilt = np.where(flip, tilt + 180.0, tilt)
        tr, tt = np.deg2rad(rot), np.deg2rad(tilt)
        d = np.stack([np.sin(tt) * np.cos(tr), np.sin(tt) * np.sin(tr),
                      np.abs(np.cos(tt))], axis=1)
        w = np.array([float(r.get("maxCC", 1.0) or 1.0) for r in rows])
        return d, w

    @staticmethod
    def _nn_sum(dirs, w):
        """Weighted nearest-neighbour distance sum of one or a batch of
        direction clouds: dirs (..., n, 3), w (..., n)."""
        dots = np.einsum("...ik,...jk->...ij", dirs, dirs)
        a = np.abs(np.arccos(np.clip(dots, -1.0, 1.0)))
        invalid = (a <= 1e-5) | (dots >= 1)
        a = np.where(invalid, np.inf, a)
        j = np.argmin(a, axis=-1)
        ann = np.take_along_axis(a, j[..., None], axis=-1)[..., 0]
        w2 = np.take_along_axis(np.broadcast_to(
            w[..., None, :], a.shape), j[..., None], axis=-1)[..., 0]
        W = ann * np.exp(np.abs(w - w2)) * np.exp(-(w + w2))
        W = np.where(np.isfinite(ann), np.where(W == 0, ann, W), 0.0)
        s = W.sum(axis=-1)
        n = dirs.shape[-2]
        return np.where(s == 0, 0.075 * n, s)

    def run(self):
        import os
        self.refuse_unread("-i2", "--sampling", "--angles_file",
                           "--angles_file_ref", "--sym", "--check_mirrors",
                           "--dontUseWeights", item=13)
        fn_parts = (self.getParam("--i")
                    if self.checkParam("--i") and self.getParam("--i")
                    else self.getParam("-i"))
        odir = self.getParam("--odir")
        sig = self.getDoubleParam("--significance_noise")
        use_sig = self.checkParam("--useSignificant")
        md = MetaData(fn_parts)
        gal_fn = os.path.join(odir, "gallery.doc")
        md_gal = MetaData(gal_fn) if os.path.exists(gal_fn) else \
            (MetaData(self.getParam("--gallery"))
             if self.checkParam("--gallery")
             and self.getParam("--gallery") not in ("", ".") else md)
        gal_dirs, _ = self._dirs_w(list(md_gal.iterRows()))
        key = "imageIndex" if use_sig else "itemId"
        clouds: dict = {}
        for r in md.iterRows():
            clouds.setdefault(int(r.get(key, 0)), []).append(r)
        T = 500
        rng = np.random.default_rng(0)
        out_rows = []
        for idx in sorted(clouds):
            rows = clouds[idx]
            dirs, w = self._dirs_w(rows)
            n = len(rows)
            sum_w = float(self._nn_sum(dirs, w))
            pick = rng.integers(0, len(gal_dirs), size=(T, n))
            rnd_dirs = gal_dirs[pick]                      # (T, n, 3)
            w_sh = np.stack([rng.permutation(w) for _ in range(T)])
            sum_u = self._nn_sum(rnd_dirs, w_sh)           # (T,)
            H = np.sort(sum_w / (sum_w + sum_u))
            i0 = rng.permutation(T)
            i1 = rng.permutation(T)
            ok = sum_u[i0] != sum_u[i1]
            H0 = np.sort((sum_u[i0] / (sum_u[i0] + sum_u[i1]))[ok])
            if len(H0) == 0:
                # degenerate cloud (e.g. a single orientation): all random
                # sums coincide, the Hopkins ratio is exactly 1/2
                H0 = np.array([0.5])
            q = H0[min(int((1 - sig) * len(H0)), len(H0) - 1)]
            P = float((q / H).mean())
            out_rows.append({key: idx, "weight": P})
        fn_ct = (self.getParam("-o")
                 if self.checkParam("-o") and self.getParam("-o")
                 else os.path.join(odir, "clusteringTendency.xmd"))
        MetaData.fromRows(out_rows).write(fn_ct)
        P_all = np.array([r["weight"] for r in out_rows])
        validation = float((P_all > 1).mean()) if len(P_all) else 0.0
        MetaData.fromRows([{"image": self.getParam("--volume")
                            or "validation",
                            "weight": validation}]).write(
            os.path.join(odir, "validation.xmd"))
        self.score = validation
        self.P = P_all
        if self.verbose:
            print(f"Validation score: {validation:.3f}")


def compare_grid_angles(degstep):
    """The reference's evenly-spaced (rot, tilt) comparison grid
    (compare_views.cpp readParams: degstep -> 360/ROUND(360/degstep),
    rot in [0, 360], tilt in [0, 180], both inclusive)."""
    degstep = 360.0 / round(360.0 / degstep)
    n_rot = int(360.0 / degstep)
    n_tilt = int(180.0 / degstep)
    rot = np.arange(n_rot + 1, dtype=np.float32) * degstep
    tilt = np.arange(n_tilt + 1, dtype=np.float32) * degstep
    return rot, tilt, degstep


def project_both_on_grid(fn1, fn2, degstep, device=None):
    """Project two volumes on the shared (rot, tilt) grid in ONE batched
    Fourier-slice pass per volume on `device` (the reference loops
    projectVolume per cell across a thread pool). Returns two tensors."""
    from xmipp3_tpu_torch.ops.project import FourierProjector
    v1 = np.squeeze(Image(fn1).data).astype(np.float32)
    v2 = np.squeeze(Image(fn2).data).astype(np.float32)
    rot, tilt, degstep = compare_grid_angles(degstep)
    rr = np.repeat(rot, len(tilt))
    tt = np.tile(tilt, len(rot))
    psi = np.zeros_like(rr)
    p1 = FourierProjector(v1, device=device).project_euler(rr, tt, psi)
    p2 = FourierProjector(v2, device=device).project_euler(rr, tt, psi)
    return p1, p2, len(rot), len(tilt)


class ProgCompareViews(XmippProgram):
    """Full reference surface (compare_views.cpp:38-44): -v1/-v2 volumes,
    --degstep grid, output = (rot, tilt) image of correlationIndex between
    the two volumes' projections at each grid orientation. --thr is the
    reference's host thread pool; here the whole grid is one batch on the
    card (flag accepted for CLI parity)."""
    name = "xmipp_compare_views"

    def defineParams(self):
        self.addUsageLine("Compare the projections of two volumes over a "
                          "(rot, tilt) grid; output is the correlation "
                          "image of the grid.")
        self.addParamsLine("   -v1 <volume>  : First volume to compare")
        self.addParamsLine("   -v2 <volume>  : Second volume to compare")
        self.addParamsLine("  [-o <image=\"\">] : Output correlation image")
        self.addParamsLine("  [--degstep <d=5.0>] : Degrees step size for "
                           "rot and tilt angles")
        self.addParamsLine("  [--thr <N=-1>] : Max processing threads "
                           "(device batching replaces the thread pool)")

    def run(self):
        from xmipp3_tpu_torch.ops.shift import correlation_index
        p1, p2, n_rot, n_tilt = project_both_on_grid(
            self.getParam("-v1"), self.getParam("-v2"),
            self.getDoubleParam("--degstep"),
            resolve_device(self.getParam("--device")))
        cc = correlation_index(p1, p2).cpu().numpy().reshape(n_rot, n_tilt)
        fn_out = self.getParam("-o") or "Rot_tilt_corr_map.xmp"
        save_image(fn_out, cc.astype(np.float32))
        self.corr_image = cc
        if self.verbose:
            print(f"mean grid correlation: {cc.mean():.4f}")


PROGRAM = None
