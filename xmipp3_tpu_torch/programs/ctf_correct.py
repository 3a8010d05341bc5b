"""CTF correction programs: ctf_phase_flip, ctf_correct_wiener2d,
ctf_group, ctf_sort_psds and ctf_enhance_psd, on the card.

Contracts: reference ctf_phase_flip.{h,cpp}, ctf_correct_wiener2d,
ctf_group, ctf_sort_psds (PSDEvaluation, ctf_sort_psds.h:36) and
ctf_enhance_psd, with the flags and outputs of the reference package's
programs (programs/ctf_correct.py). Phase flip and Wiener are
XmippMetadataPrograms: a stack, an image or a metadata in, a stack or
metadata out. With --ctf one CTF filters every image; otherwise each row's
own CTF (inline ctf* labels or a ctfModel file) filters its image, and a
batch's per-row CTFs are evaluated in one pass (ops.ctf.generate_2d_rows)
where the reference evaluates them one image at a time. ctf_group and
ctf_sort_psds evaluate the port's CTF model on the card and do their
grouping, statistics and tests on the host, as the reference does;
ctf_enhance_psd runs its median filter on the host and its band-pass on
the card.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.ctf import (CTFDescription, phase_flip,
                                      wiener_filter_2d)


def _row_ctf(row, sampling=None, cache=None) -> CTFDescription:
    """The CTF of a metadata row: its ctfModel file (parsed once per path
    when a cache dict is given) or its inline ctf* labels; `sampling`, when
    given, overrides the sampling rate."""
    if "ctfModel" in row and row["ctfModel"]:
        fn = str(row["ctfModel"])
        if cache is None:
            ctf = CTFDescription.from_metadata(fn)
        else:
            if fn not in cache:
                cache[fn] = CTFDescription.from_metadata(fn)
            ctf = copy.copy(cache[fn])
    else:
        ctf = CTFDescription.from_row(row)
    if sampling:
        ctf.sampling_rate = sampling
    return ctf


class _CTFProgram(XmippMetadataProgram):
    """The CTF that filters a batch: the --ctf file's for every image, or
    one per row."""

    def preProcess(self):
        self._ctf_cache = {}

    def _file_ctf(self) -> CTFDescription:
        return CTFDescription.from_metadata(self.fn_ctf)

    def _ctfs(self, rows):
        if self.fn_ctf:
            return self._file_ctf()
        return [_row_ctf(r, self.Ts if self.Ts > 0 else None,
                         self._ctf_cache) for r in rows]

    def _batch(self, imgs):
        return torch.as_tensor(imgs, device=self.device)


class ProgCTFPhaseFlip(_CTFProgram):
    name = "xmipp_ctf_phase_flip"
    apply_geo = False

    def defineProcessParams(self):
        self.addUsageLine("Correct the phase of the CTF (sign flip).")
        self.addParamsLine("  [--ctf <ctfparam=\"\">] : CTF file (else per-row ctf columns)")
        self.addParamsLine("  [--sampling <Ts=0>]  : Override sampling rate")
        self.addParamsLine("   alias --sampling_rate;")
        self.addParamsLine("  [--downsampling <D=1>] : Downsampling factor of the input wrt the original micrograph (Ts defaults to ctfparam sampling x D, ctf_phase_flip.cpp:37-40)")

    def readProcessParams(self):
        self.fn_ctf = self.getParam("--ctf") if self.checkParam("--ctf") else ""
        self.Ts = self.getDoubleParam("--sampling")
        self.downsampling = (self.getDoubleParam("--downsampling")
                             if self.checkParam("--downsampling") else 1.0)

    def _file_ctf(self):
        ctf = CTFDescription.from_metadata(self.fn_ctf)
        if self.Ts > 0:
            ctf.sampling_rate = self.Ts
        elif self.downsampling != 1.0:
            ctf.sampling_rate = ctf.sampling_rate * self.downsampling
        return ctf

    def processBatch(self, imgs, rows):
        return phase_flip(self._batch(imgs), self._ctfs(rows))


class ProgCTFCorrectWiener2D(_CTFProgram):
    name = "xmipp_ctf_correct_wiener2d"

    def defineProcessParams(self):
        self.addUsageLine("Wiener-filter CTF correction of images.")
        self.addParamsLine("  [--ctf <ctfparam=\"\">] : CTF file (else per-row ctf columns)")
        self.addParamsLine("  [--sampling_rate <Ts=0>] : Override sampling")
        self.addParamsLine("  [--wc <w=-1>]        : Wiener constant (<0: FREALIGN default, 10% of mean CTF power)")
        self.addParamsLine("  [--phase_flipped]    : Images are already phase flipped")
        self.addParamsLine("  [--isIsotropic]      : Treat the defocus as isotropic (mean of U/V)")
        self.addParamsLine("  [--pad <factor=2.>]  : Padding factor for the Wiener correction")
        self.addParamsLine("  [--correct_envelope] : Also correct the CTF envelope")

    def readProcessParams(self):
        self.fn_ctf = self.getParam("--ctf") if self.checkParam("--ctf") else ""
        self.Ts = self.getDoubleParam("--sampling_rate")
        self.wc = self.getDoubleParam("--wc")
        self.flipped = self.checkParam("--phase_flipped")
        self.isotropic = self.checkParam("--isIsotropic")
        self.pad = (self.getDoubleParam("--pad")
                    if self.checkParam("--pad") else 2.0)
        self.envelope = self.checkParam("--correct_envelope")

    def _file_ctf(self):
        ctf = CTFDescription.from_metadata(self.fn_ctf)
        if self.Ts > 0:
            ctf.sampling_rate = self.Ts
        return ctf

    def processBatch(self, imgs, rows):
        return wiener_filter_2d(self._batch(imgs), self._ctfs(rows), self.wc,
                                isIsotropic=self.isotropic,
                                phase_flipped=self.flipped, pad=self.pad,
                                correct_envelope=self.envelope)


class ProgCTFGroup(XmippProgram):
    """Full reference surface ctf_group.cpp:34-790: auto (max CTF-profile
    error up to a resolution), simple (defocus bins) and manual (split
    docfile) grouping; per-group averaged CTF filter stacks and Wiener
    filters; Info/split/images.sel outputs."""
    name = "xmipp_ctf_group"

    def defineParams(self):
        self.addUsageLine("Group images by similar CTF.")
        self.addParamsLine("   --ctfdat <ctfdat_file> : Metadata with "
                           "per-image CTF info")
        self.addParamsLine("  [--oroot <root=ctf_group>] : Output rootname")
        self.addParamsLine("  [-o <oext=\"ctf:stk\">] : Output name:format "
                           "for the filter stacks (ctf:mrc to force MRC)")
        self.addParamsLine("  [--pad <float=1>] : Padding factor")
        self.addParamsLine("  [--phase_flipped] : Output filters for "
                           "phase-flipped data")
        self.addParamsLine("  [--discard_anisotropy] : Exclude anisotropic "
                           "CTFs from groups")
        self.addParamsLine("  [--wiener] : Also calculate Wiener filters")
        self.addParamsLine("  [--sampling_rate <s=-1>] : Overwrite the "
                           "sampling rate of the ctf.param files")
        self.addParamsLine("  [--do1Dctf] : Compute groups using 1D CTFs "
                           "(many groups)")
        self.addParamsLine("  [--wc <float=-1>] : Wiener-filter constant "
                           "(<0: FREALIGN default, 10% of the mean)")
        self.addParamsLine("  [--error <float=0.5>] : Maximum allowed "
                           "error (auto mode)")
        self.addParamsLine("  [--resol <float=-1>] : Resolution (A) for "
                           "the error calculation (-1 = Nyquist)")
        self.addParamsLine("  [--simple <bins=-1>] : Simple algorithm on "
                           "defocus bins of size (max-min)/bins")
        self.addParamsLine("  [--split <docfile=\"\">] : Manual mode: "
                           "1-column docfile with defocus split values")
        self.addParamsLine("  [--maxdiff <d=-1>] : (legacy) group by max "
                           "defocus difference instead")

    def _pure(self, ctf, fx, fy):
        return ctf.pure_at(fx, fy, device=self.device).cpu().numpy()

    def run(self):
        self.device = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("--ctfdat"))
        root = self.getParam("--oroot")
        simple_bins = self.getIntParam("--simple")
        fn_split = self.getParam("--split")
        do_auto = not fn_split
        max_error = self.getDoubleParam("--error")
        pad = self.getDoubleParam("--pad")
        phase_flipped = self.checkParam("--phase_flipped")
        do_wiener = self.checkParam("--wiener")
        wc = self.getDoubleParam("--wc")
        fmt = "stk"
        if self.checkParam("-o"):
            oext = self.getParam("-o")
            fmt = oext.split(":", 1)[1] if ":" in oext else oext

        du = md.getColumn("ctfDefocusU").astype(float)
        dv = md.getColumn("ctfDefocusV").astype(float) if \
            md.containsLabel("ctfDefocusV") else du.copy()
        defocus = 0.5 * (du + dv)

        # legacy defocus-difference clustering (pre-reference surface)
        if self.checkParam("--maxdiff") and \
                self.getDoubleParam("--maxdiff") > 0:
            maxdiff = self.getDoubleParam("--maxdiff")
            order = np.argsort(defocus)
            groups = np.zeros(len(md), int)
            g = 0
            start_val = None
            for k in order:
                if start_val is None or defocus[k] - start_val > maxdiff:
                    g += 1
                    start_val = defocus[k]
                groups[k] = g
            self._write_groups(md, groups, root)
            self.n_groups = g
            return

        if simple_bins > 0:
            # simpleRun (ctf_group.cpp:721-757): bins on defocusU
            dmin, dmax = du.min(), du.max()
            istep = 1.0 / max((dmax - dmin) / simple_bins, 1e-30)
            groups = (np.floor((du - dmin) * istep) + 1).astype(int)
            self._write_groups(md, groups, root)
            self._write_images_sel(md, groups, root)
            self.n_groups = int(groups.max())
            return

        # group identical CTFs (groupCTFMetaData analog)
        keys = [(float(du[i]), float(dv[i]),
                 float(md.getRow(j).get("ctfDefocusAngle", 0.0)))
                for i, j in enumerate(md)]
        uniq = sorted(set(keys), key=lambda k: -(k[0] + k[1]))
        key_to_u = {k: n for n, k in enumerate(uniq)}
        img_u = np.array([key_to_u[k] for k in keys])
        counts = np.bincount(img_u, minlength=len(uniq)).astype(float)

        rows0 = md.getRow(next(iter(md)))
        Ts = self.getDoubleParam("--sampling_rate")
        base = _row_ctf(rows0, Ts if Ts > 0 else None)
        if Ts <= 0:
            Ts = base.sampling_rate
        dim = 64
        if md.containsLabel("image"):
            try:
                first = Image(str(rows0["image"])).data
                dim = first.shape[-1]
            except Exception:
                pass
        paddim = int(round(pad * dim))
        nrad = int(np.sqrt(2.0) * paddim + 1)
        resol = self.getDoubleParam("--resol")
        resol_err = 2.0 * Ts if resol < 0 else resol
        resol_err = min(0.5, Ts / resol_err)
        iresol = int(round(resol_err * paddim))

        # radial CTF tables: table[r] = CTF at freq r/(paddim*Ts)
        # (produceSideInfo, ctf_group.cpp:259-300: averaged defocus,
        # Tm /= sqrt(2) 1-row trick)
        fr = np.arange(nrad) / (paddim * Ts)
        tables = np.zeros((len(uniq), nrad), np.float32)
        keep = np.ones(len(uniq), bool)
        for n, (u, v, ang) in enumerate(uniq):
            ctf = dataclasses.replace(base, defocusU=0.5 * (u + v),
                                      defocusV=0.5 * (u + v),
                                      azimuthal_angle=0.0)
            if self.checkParam("--discard_anisotropy"):
                aniso = dataclasses.replace(base, defocusU=u, defocusV=v,
                                            azimuthal_angle=ang)
                if not self._is_isotropic(aniso, resol_err, max_error, Ts):
                    keep[n] = False
                    if self.verbose:
                        print(f" Discard CTF {u}/{v} because of too large "
                              "anisotropy")
                    continue
            t = self._pure(ctf, fr, np.zeros_like(fr))
            tables[n] = np.abs(t) if phase_flipped else t

        # assign groups over kept CTFs, sorted by defocus desc (autoRun,
        # ctf_group.cpp:420-486 / manualRun :488-536)
        kept = np.where(keep)[0]
        groups_u = np.zeros(len(uniq), int)
        if do_auto:
            members: list[list[int]] = []
            for n in kept:
                placed = False
                for gi, mem in enumerate(members):
                    for m in mem:
                        if (np.abs(tables[n, :iresol + 1] -
                                   tables[m, :iresol + 1])
                                < max_error).all():
                            groups_u[n] = gi + 1
                            mem.append(n)
                            placed = True
                            break
                    if placed:
                        break
                if not placed:
                    members.append([n])
                    groups_u[n] = len(members)
            g = len(members)
        else:
            split_md = MetaData(fn_split)
            col = "ctfDefocusA" if split_md.containsLabel("ctfDefocusA") \
                else split_md.activeLabels()[0]
            splits = np.sort(np.asarray(split_md.getColumn(col),
                                        float))[::-1]
            avg = np.array([(uniq[n][0] + uniq[n][1]) / 2 for n in kept])
            groups_kept = np.searchsorted(-splits, -avg, side="right") + 1
            groups_u[kept] = groups_kept
            g = int(groups_kept.max()) if len(groups_kept) else 0

        groups = groups_u[img_u]
        self.n_groups = g
        self._write_groups(md, groups, root)
        self._write_images_sel(md, groups, root)

        # Info.xmd: per-group micrograph/image counts + defocus stats
        avg_u = np.array([(k[0] + k[1]) / 2 for k in uniq])
        info_rows = []
        for gi in range(1, g + 1):
            sel = kept[groups_u[kept] == gi]
            info_rows.append({
                "defGroup": gi, "count": int(len(sel)),
                "sum": float(counts[sel].sum()),
                "min": float(avg_u[sel].min()),
                "max": float(avg_u[sel].max()),
                "avg": float(avg_u[sel].mean())})
        MetaData.fromRows(info_rows).write(f"groups@{root}Info.xmd")
        MetaData.fromRows([{"count": g}]).write(
            f"numberGroups@{root}Info.xmd", append=True)
        # split docfile: midpoints between consecutive groups
        split_rows = [{"ctfDefocusA":
                       (info_rows[i]["min"] + info_rows[i + 1]["max"]) / 2}
                      for i in range(g - 1)]
        if split_rows:
            MetaData.fromRows(split_rows).write(root + "_split.doc")

        # per-group averaged 2-D CTF (+ Wiener) via the radial tables
        # (writeOutputToDisc, ctf_group.cpp:639-721)
        ii = np.arange(paddim)
        ii = np.minimum(ii, paddim - ii)
        d = np.sqrt(ii[:, None] ** 2 + ii[None, :] ** 2)
        idd = d.astype(int)
        frac = (d - idd).astype(np.float32)
        ctf2d_u = (frac[None] * tables[:, np.minimum(idd + 1, nrad - 1)]
                   + (1 - frac)[None] * tables[:, idd])
        if do_wiener:
            mwien = (counts[keep, None, None] * ctf2d_u[keep] ** 2).sum(0) \
                / max(counts[keep].sum(), 1e-30)
            if wc < 0:
                wc = 0.1 * float(mwien.mean())
            mwien = mwien + wc
        gstack = np.zeros((g, paddim, paddim), np.float32)
        for gi in range(1, g + 1):
            sel = kept[groups_u[kept] == gi]
            w = counts[sel] / max(counts[sel].sum(), 1e-30)
            gstack[gi - 1] = (w[:, None, None] * ctf2d_u[sel]).sum(0)
        ext = "mrcs" if fmt in ("stk", "mrcs") else fmt
        save_image(f"{root}_ctf.{ext}", gstack)
        if do_wiener:
            save_image(f"{root}_wien.{ext}",
                       (gstack / mwien[None]).astype(np.float32))
        if self.verbose:
            print(f"Created {g} CTF groups")

    def _is_isotropic(self, ctf, resol_err, max_error, Ts):
        """isIsotropic (ctf_group.cpp:391-418): compare the CTF along the
        astigmatism axis against the swapped axis up to resol_err."""
        dig = np.arange(0.0, resol_err, 0.001)
        cosp = np.cos(np.deg2rad(ctf.azimuthal_angle))
        sinp = np.sin(np.deg2rad(ctf.azimuthal_angle))
        fx, fy = cosp * dig / Ts, sinp * dig / Ts
        a = self._pure(ctf, fx, fy)
        b = self._pure(ctf, fy, fx)
        return bool((np.abs(a - b) <= max_error).all())

    @staticmethod
    def _write_groups(md, groups, root):
        rows = []
        for n, i in enumerate(md):
            r = md.getRow(i)
            r["defGroup"] = int(groups[n])
            rows.append(r)
        MetaData.fromRows(rows).write(root + ".xmd")

    @staticmethod
    def _write_images_sel(md, groups, root):
        rows_by_g: dict[int, list] = {}
        for n, i in enumerate(md):
            r = md.getRow(i)
            r["defGroup"] = int(groups[n])
            rows_by_g.setdefault(int(groups[n]), []).append(r)
        first = True
        for gi in sorted(rows_by_g):
            MetaData.fromRows(rows_by_g[gi]).write(
                f"ctfGroup{gi:06d}@{root}_images.sel", append=not first)
            first = False


def _model_criteria(ctf, device, crits: dict):
    """Into crits, in order: the model's own criteria (reference ctf_sort_psds.cpp: first zero
    and its ratio, damping, the azimuth-averaged first zero and the
    astigmatic disagreement, first minimum vs first zero, max meaningful
    frequency, non-astigmatic validity)."""
    fz = ctf.first_zero_freq(device=device)
    crits["ctfCritFirstZero"] = fz
    crits["ctfCritFirstZeroRatio"] = (
        max(ctf.defocusU, ctf.defocusV) /
        max(min(ctf.defocusU, ctf.defocusV), 1.0))
    crits["ctfCritDamping"] = float(ctf.damping_2d(64, 64,
                                                   device=device).mean())
    # azimuth-averaged first zero + astigmatic disagreement
    # (reference MDL_CTF_CRIT_FIRSTZEROAVG / DISAGREEMENT)
    zU = fz
    ctfV = dataclasses.replace(ctf, defocusU=ctf.defocusV,
                               defocusV=ctf.defocusV)
    zV = ctfV.first_zero_freq(device=device)
    crits["ctfCritFirstZeroAvg"] = 0.5 * (zU + zV)
    crits["ctfCritFirstZeroDisagreement"] = abs(zU - zV)
    # first minimum of |CTF| after the first zero vs first zero
    # (reference FIRSTMINIMUM_FIRSTZERO_RATIO / _DIFF_RATIO)
    f = np.linspace(1e-4, 0.5 / ctf.sampling_rate, 2048)
    vals = ctf.pure_at(f, np.zeros_like(f), damped=False,
                       device=device).abs().cpu().numpy()
    iz = int(np.searchsorted(f, fz))
    if 0 < iz < len(f) - 2:
        seg = vals[iz:]
        imin = iz + int(np.argmin(seg[: max(len(seg) // 4, 2)]))
        fmin = f[imin]
        crits["ctfCritFirstMinFirstZeroRatio"] = float(fmin / max(fz, 1e-9))
        crits["ctfCritFirstMinFirstZeroDiffRatio"] = \
            float((fmin - fz) / max(fz, 1e-9))
    # max meaningful frequency: envelope drops below 1%
    # (reference MDL_CTF_CRIT_MAXFREQ)
    damp = ctf.pure_at(f, np.zeros_like(f), damped=True,
                       device=device).abs().cpu().numpy()
    env_ok = np.where(damp > 0.01 * damp.max())[0]
    crits["ctfCritMaxFreq"] = float(
        1.0 / max(f[env_ok[-1]], 1e-6)) if len(env_ok) else 0.0
    # non-astigmatic validity (reference
    # MDL_CTF_CRIT_NONASTIGMATICVALIDITY): zero-crossing count agreement
    # between U and V profiles inside max freq
    crits["ctfCritNonAstigmaticValidity"] = float(
        abs(zU - zV) / max(0.5 * (zU + zV), 1e-9))


def _psd_criteria(psd, f1, f2, decay, m1, m2, device, crits: dict):
    """Into crits, in order: the PSD's criteria (reference PSDEvaluation): the enhanced PSD's
    intensity, stdQ, the radial integral, the 90-degree self-correlation
    and the normality of its high-frequency half."""
    import scipy.stats

    from xmipp3_tpu_torch.ops.psd import radial_profile
    enh = enhance_psd_filter(psd, f1, f2, decay, m1, m2, device=device)
    crits["ctfCritPsdInt"] = float(np.abs(enh).mean())
    crits["ctfCritPsdStdQ"] = float(psd.std() / max(psd.mean(), 1e-12))
    n = psd.shape[0]
    half = np.ascontiguousarray(np.fft.ifftshift(psd)[:, : n // 2 + 1])
    _, prof = radial_profile(half, device=device)
    crits["ctfCritPsdRadialIntegral"] = float(prof.sum())
    # 90-degree self-correlation: low for astigmatic or drifted PSDs
    # (reference MDL_CTF_CRIT_PSDCORRELATION90)
    rot90 = np.rot90(psd)
    a = psd - psd.mean()
    b = rot90 - rot90.mean()
    crits["ctfCritPsdCorr90"] = float(
        (a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))
    # background-residual normality z (reference MDL_CTF_CRIT_NORMALITY):
    # kurtosis+skew test of the high-frequency half of the PSD
    hf = psd[np.abs(np.fft.fftshift(np.fft.fftfreq(n)))[:, None] > 0.25]
    if hf.size > 32:
        crits["ctfCritNormality"] = float(
            scipy.stats.normaltest(hf.ravel()).statistic)


def _fitting_criteria(ctf, psd, device) -> dict:
    """Model-vs-PSD fitting correlations (reference FITTINGSCORE /
    FITTINGCORR13): overall and first-third-band agreement of the log
    model (the port's CTF model on the card) with the log PSD."""
    n = psd.shape[0]
    half = np.ascontiguousarray(
        np.fft.ifftshift(psd)[:, : n // 2 + 1]).astype(np.float32)
    Ts = ctf.sampling_rate
    fy = np.fft.fftfreq(n).astype(np.float32)[:, None] / Ts
    fx = np.fft.rfftfreq(n).astype(np.float32)[None, :] / Ts
    model = ctf.pure_at(fx, fy, device=device).cpu().numpy() ** 2 \
        + ctf.noise_at(fx, fy, device=device).cpu().numpy()
    lm = np.log1p(np.maximum(model, 0))
    lo = np.log1p(np.maximum(half, 0))
    rdig = np.sqrt((fy * Ts) ** 2 + (fx * Ts) ** 2)

    def corr_in(sel):
        aa = lm[sel] - lm[sel].mean()
        bb = lo[sel] - lo[sel].mean()
        return float((aa * bb).sum() /
                     max(np.linalg.norm(aa) * np.linalg.norm(bb), 1e-12))

    return {"ctfCritFittingScore": corr_in((rdig > 0.02) & (rdig < 0.45)),
            "ctfCritFittingCorr13": corr_in((rdig > 0.02)
                                            & (rdig < 0.45 / 3))}


class ProgCTFSortPSDs(XmippProgram):
    """Full reference surface ctf_sort_psds.cpp:43-134: 20+ quality
    criteria; the enhancement-filter parameters feed the enhanced-PSD
    criteria. As in the reference, a group of criteria that cannot be
    computed for a row (no model, no PSD, a failed read) is left out of
    that row."""
    name = "xmipp_ctf_sort_psds"

    def defineParams(self):
        self.addUsageLine("Evaluate CTF estimation quality (PSD criteria).")
        self.addParamsLine("   -i <metadata> : Metadata with ctfModel/psd columns")
        self.addParamsLine("  [-o <metadata=\"\">] : Output (default in-place)")
        self.addParamsLine("  [--label <image_label=micrograph>] : Label "
                           "used to read/write images")
        self.addParamsLine("  [-f1 <freq_low=0.02>] : Low freq for the "
                           "enhancement band pass (max 0.5)")
        self.addParamsLine("  [-f2 <freq_high=0.2>] : High freq for the "
                           "enhancement band pass (max 0.5)")
        self.addParamsLine("  [-decay <freq_decay=0.02>] : Decay of the "
                           "transition bands")
        self.addParamsLine("  [-m1 <mfreq_low=0.01>] : Low freq for the "
                           "enhancement mask (max 0.5)")
        self.addParamsLine("  [-m2 <mfreq_high=0.45>] : High freq for the "
                           "enhancement mask (max 0.5)")

    def run(self):
        device = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        band = [self.getDoubleParam(f) for f in ("-f1", "-f2", "-decay",
                                                 "-m1", "-m2")]
        self.image_label = self.getParam("--label")
        rows = []
        for i in md:
            r = md.getRow(i)
            crits = {}
            try:
                ctf = _row_ctf(r)
                _model_criteria(ctf, device, crits)
            except Exception:
                pass
            has_psd = "psd" in r and r["psd"]
            if has_psd:
                try:
                    psd = np.squeeze(Image(str(r["psd"])).data)
                    _psd_criteria(psd, *band, device, crits)
                except Exception:
                    pass
            if has_psd and "ctfCritFirstZero" in crits:
                try:
                    psd = np.squeeze(Image(str(r["psd"])).data)
                    crits.update(_fitting_criteria(ctf, psd, device))
                except Exception:
                    pass
            r.update(crits)
            rows.append(r)
        out = MetaData.fromRows(rows)
        out.write(self.getParam("-o") if self.checkParam("-o") and
                  self.getParam("-o") else self.getParam("-i"))


def enhance_psd_filter(psd, f1, f2, decay, m1, m2, do_log=True,
                       center=True, device=None):
    """ProgCTFEnhancePSD::applyFilter (ctf_enhance_psd.cpp:110-208):
    log10 -> 3x3 median -> outlier clamp -> raised-cosine bandpass (on
    `device`) -> frequency mask [m1,m2] -> normalize under the tight outer
    ring -> inner mask [m1, 0.9*m2] -> center."""
    from scipy.ndimage import median_filter

    from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                     band_pass_mask)
    p = np.asarray(psd, np.float64)
    if do_log:
        p = np.log10(1 + np.maximum(p, 0))
    # centered representation for the median/outlier steps
    p = np.fft.fftshift(p)
    p = median_filter(p, size=3)
    mu, sd = p.mean(), max(p.std(), 1e-12)
    p = np.clip(p, mu - 2 * sd, mu + 2 * sd)
    H, W = p.shape
    p = apply_fourier_mask_2d(
        p.astype(np.float32), band_pass_mask(H, W, f1, f2, raised_w=decay),
        device=device).cpu().numpy().astype(np.float64)
    p = np.fft.ifftshift(p)
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    f2d = fy * fy + fx * fx
    mask = (f2d >= m1 * m1) & (f2d <= m2 * m2)
    p = np.where(mask, p, 0.0)
    tight = (f2d > (0.9 * m2) ** 2) & (f2d < m2 * m2)
    avg = p[tight].mean() if tight.any() else 0.0
    std = max(p[tight].std() if tight.any() else 1.0, 1e-12)
    p = np.where(mask, (p - avg) / std, p)
    inner = (f2d >= m1 * m1) & (f2d <= (0.9 * m2) ** 2)
    p = np.where(inner, p, 0.0)
    if center:
        p = np.fft.fftshift(p)
    return p.astype(np.float32)


class ProgCTFEnhancePSD(XmippMetadataProgram):
    """Full reference surface ctf_enhance_psd.cpp:40-216."""
    name = "xmipp_ctf_enhance_psd"

    def defineProcessParams(self):
        self.addUsageLine("Enhance PSD rings for visualization/fitting "
                          "(bandpass + local normalization).")
        self.addParamsLine("  [--method <mth=filter>] : Enhancing method")
        self.addParamsLine("    where <mth>")
        self.addParamsLine("       filter <freq_low=0.05> <freq_high=0.2> "
                           "<freq_decay=0.02> : Raised-cosine bandpass "
                           "enhancement")
        self.addParamsLine("       spht <N0=1> <NF=10> : Spiral phase "
                           "transform normalization (the reference "
                           "implementation is an FFT roundtrip no-op, "
                           "ctf_enhance_psd.cpp:209-216; mirrored here)")
        self.addParamsLine("  [--dont_center] : Do not center the output")
        self.addParamsLine("  [--dont_log] : Don't take log10 before "
                           "working")
        self.addParamsLine("  [--m1 <freq_low=0.025>] : Low freq for the "
                           "output frequency mask (max 0.5)")
        self.addParamsLine("  [--m2 <freq_high=0.3>] : High freq for the "
                           "output frequency mask (max 0.5)")
        self.addParamsLine("  [--f1 <w=-1>] : (legacy) lower band limit")
        self.addParamsLine("  [--f2 <w=-1>] : (legacy) upper band limit")

    def readProcessParams(self):
        toks = self.getListParam("--method") or ["filter"]
        self.method = toks[0]
        if self.method == "filter":
            self.f1 = float(toks[1]) if len(toks) > 1 else 0.05
            self.f2 = float(toks[2]) if len(toks) > 2 else 0.2
            self.decay = float(toks[3]) if len(toks) > 3 else 0.02
        else:
            self.f1, self.f2, self.decay = 0.05, 0.2, 0.02
        if self.checkParam("--f1") and self.getDoubleParam("--f1") > 0:
            self.f1 = self.getDoubleParam("--f1")
        if self.checkParam("--f2") and self.getDoubleParam("--f2") > 0:
            self.f2 = self.getDoubleParam("--f2")
        self.m1 = self.getDoubleParam("--m1")
        self.m2 = self.getDoubleParam("--m2")
        self.do_log = not self.checkParam("--dont_log")
        self.center = not self.checkParam("--dont_center")

    def processBatch(self, imgs, rows):
        out = np.empty_like(imgs)
        for i in range(len(imgs)):
            if self.method == "spht":
                # reference applySPHT is an exact FFT roundtrip
                out[i] = np.fft.irfft2(np.fft.rfft2(imgs[i]),
                                       imgs[i].shape).astype(np.float32)
            else:
                out[i] = enhance_psd_filter(imgs[i], self.f1, self.f2,
                                            self.decay, self.m1, self.m2,
                                            self.do_log, self.center,
                                            device=self.device)
        return out


PROGRAM = ProgCTFPhaseFlip
