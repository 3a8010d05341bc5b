"""CTF estimation programs, on the card.

xmipp_ctf_estimate_from_micrograph — tile the micrograph, periodogram
  PSD(s), fit the full CTF model; --mode micrograph|regions|particles with
  the local defocus plane and the PSD-PCA quality criteria (reference
  ctf_estimate_from_micrograph.cpp:289-670).
xmipp_ctf_estimate_from_psd — full-model fit on a precomputed PSD
  (reference ctf_estimate_from_psd.cpp).
xmipp_ctf_estimate_from_psd_fast — 1-D radial-average variant (reference
  ctf_estimate_from_psd_fast.cpp — a distinct, isotropic algorithm).

The flags and outputs are those of the reference package's programs
(programs/ctf_estimate.py). The micrograph goes to the card once; its
pieces are gathered there, their periodograms are one batched rfft2, and
the model fit runs there (models/ctf_estimation.py). The PCA criteria,
the background fits and the plane fit are host numpy, as in the
reference. Flags that the reference accepts and ignores raise here
(ROADMAP.md §3 item 6). Programs run on the card unless `--device cpu`
is given; under --mesh only rank 0 writes files.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.models.ctf_estimation import (CTFEstimator, STAGE_SETS,
                                                    estimate_ctf_1d,
                                                    fit_defocus_plane)
from xmipp3_tpu_torch.ops.psd import (gather_pieces, gather_tiles,
                                      psd_half_to_full_centered,
                                      tile_positions)

# flags of the reference's grammar that its fit never reads: the port
# refuses them rather than ignore them
_UNREAD = ("--energy_loss", "--lens_stability", "--convergence_cone",
           "--longitudinal_displace", "--transversal_displace", "--K",
           "--phase_shift")


def _runs_test_z(signs: np.ndarray) -> float:
    """Wald-Wolfowitz runs test z-score of a +/- sequence (reference
    checkRandomness on the PCA projection signs)."""
    n = len(signs)
    if n < 2:
        return 0.0
    n1 = int((signs > 0).sum())
    n2 = n - n1
    if n1 == 0 or n2 == 0:
        return 0.0
    runs = 1 + int((signs[1:] * signs[:-1] < 0).sum())
    mu = 2.0 * n1 * n2 / n + 1
    var = 2.0 * n1 * n2 * (2.0 * n1 * n2 - n) / (n * n * (n - 1.0))
    return float((runs - mu) / max(np.sqrt(var), 1e-8)) if var > 0 else 0.0


def _piece_psds(pieces: torch.Tensor) -> torch.Tensor:
    """Per-piece windowed periodogram |F|^2/N (half rfft layout) of a
    (B, n, n) tensor, on its device."""
    from xmipp3_tpu_torch.ops.mask import raised_cosine_window_1d
    n = pieces.shape[-1]
    w1 = raised_cosine_window_1d(n)
    w2 = torch.as_tensor(w1[:, None] * w1[None, :], device=pieces.device)
    return torch.fft.rfft2(pieces * w2).abs() ** 2 / (n * n)


class _CTFFitMixin:
    def _define_fit_params(self):
        # CTF description surface (reference CTFDescription1D/2D::
        # defineParams, data/ctf.cpp: canonical --voltage/--spherical_
        # aberration/... with the short aliases)
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size (Å)")
        self.addParamsLine("     alias -s;")
        self.addParamsLine("  [--voltage <v=300>]  : Acceleration voltage (kV)")
        self.addParamsLine("     alias --kV;")
        self.addParamsLine("  [--spherical_aberration <cs=2.7>] : mm")
        self.addParamsLine("     alias --Cs;")
        self.addParamsLine("  [--chromatic_aberration <ca=2>] : mm")
        self.addParamsLine("     alias --Ca;")
        self.addParamsLine("  [--Q0 <q=0.07>]      : Amplitude contrast")
        self.addParamsLine("  [--energy_loss <espr=0>] : eV (not read by the fit: refused)")
        self.addParamsLine("  [--lens_stability <ispr=0>] : ppm (not read by the fit: refused)")
        self.addParamsLine("  [--convergence_cone <alpha=0>] : mrad (not read by the fit: refused)")
        self.addParamsLine("  [--longitudinal_displace <DeltaF=0>] : Å (not read by the fit: refused)")
        self.addParamsLine("  [--transversal_displace <DeltaR=0>] : Å (not read by the fit: refused)")
        self.addParamsLine("  [--K <K=0>]          : Global gain (not read by the fit: refused)")
        self.addParamsLine("  [--phase_shift <ps=0>] : VPP phase shift (not read by the fit: refused)")
        self.addParamsLine("  [--VPP_radius <r=0>]  : Phase-plate radius (0 = no VPP)")
        self.addParamsLine("  [--defocusU <U=0>]   : Initial defocus U (Å)")
        self.addParamsLine("  [--defocusV <V=0>]   : Initial defocus V (Å)")
        self.addParamsLine("  [--azimuthal_angle <a=0>] : Initial astigmatism angle")
        self.addParamsLine("  [--ctf_similar_to <ctfFile=\"\">] : seed "
                           "parameters from this ctfparam file (command-line "
                           "values override it)")
        # fit-constraint surface (reference ProgCTFBasicParams::
        # defineBasicParams, ctf_estimate_from_psd_base.cpp:99-168)
        self.addParamsLine("  [--min_freq <f=0.03>] : Minimum digital freq for fit")
        self.addParamsLine("  [--max_freq <f=0.35>] : Maximum digital freq for fit")
        self.addParamsLine("  [--defocus_range <D=8000>] : Defocus range (Å) "
                           "around the initial defocus (full span if none)")
        self.addParamsLine("  [--downSamplingPerformed <F=1>] : Downsampling "
                           "performed to produce this PSD; the output model "
                           "is referred to the original sampling rate")
        self.addParamsLine("  [--fastDefocus <lambda=2> <size=10>] : first "
                           "defocus from ring demodulation (only the "
                           "defaults 2 10: the sector method has neither)")
        self.addParamsLine("  [--noDefocus]        : No defocus estimation")
        self.addParamsLine("  [--selfEstimation]   : Estimate defocus without "
                           "previous estimation")
        self.addParamsLine("  [--refine_amplitude_contrast] : Refine Q0")
        self.addParamsLine("  [--show_optimization] : Show optimization process")
        self.addParamsLine("  [--radial_noise]     : radially symmetric noise "
                           "(default: astigmatic)")
        self.addParamsLine("  [--enhance_weight <w=1>] : Weight of the "
                           "enhanced-PSD term")
        self.addParamsLine("  [--model_simplification <s=0>] : 0 none, "
                           "1 simplified envelope, 2 no 2nd Gaussian, "
                           "3 symmetric intermediate Gaussian")
        self.addParamsLine("  [--bootstrapFit <N=-1>] : repeat the fit N "
                           "times on random Fourier-pixel halves to measure "
                           "variability")
        self.addParamsLine("  [--ctfmodelSize <size=256>] : size of the "
                           "ctfmodel quadrant/halfplane thumbnails")
        self.addParamsLine("  [--enhance_min_freq <f1=-1>] : enhancement "
                           "bandpass low cutoff (defaults per max_freq)")
        self.addParamsLine("  [--enhance_max_freq <f2=-1>] : enhancement "
                           "bandpass high cutoff (defaults per max_freq)")

    def _read_fit_params(self):
        for flag in _UNREAD:
            if self.checkParam(flag):
                raise XmippError(
                    ErrCode.ARG_INCORRECT,
                    f"{flag} is not read by the CTF fit: the reference "
                    "package accepts it and ignores it, and the port "
                    "refuses it rather than ignore it (ROADMAP.md §3 "
                    "item 6)")
        self.device_arg = self.getParam("--device")
        self.Ts = self.getDoubleParam("--sampling_rate")
        # seed model from a ctfparam file (overridden by explicit flags)
        self.similar = None
        if self.checkParam("--ctf_similar_to") and \
                self.getParam("--ctf_similar_to"):
            from xmipp3_tpu_torch.ops.ctf import CTFDescription
            self.similar = CTFDescription.from_metadata(
                self.getParam("--ctf_similar_to"))

        def _d(flag, attr, default):
            if self.checkParam(flag):
                return self.getDoubleParam(flag)
            if self.similar is not None and attr:
                return float(getattr(self.similar, attr))
            return default

        self.kV = _d("--voltage", "voltage", 300.0)
        self.Cs = _d("--spherical_aberration", "Cs", 2.7)
        self.Ca = _d("--chromatic_aberration", "Ca", 2.0)
        self.Q0 = _d("--Q0", "Q0", 0.07)
        self.vpp_radius = _d("--VPP_radius", "VPP_radius", 0.0)
        def0U = _d("--defocusU", "defocusU", 0.0)
        def0V = _d("--defocusV", "defocusV", 0.0)
        ang0 = _d("--azimuthal_angle", "azimuthal_angle", 0.0)
        if def0U and not def0V:
            def0V = def0U
        self.initial_defocus = (def0U, def0V, ang0) if def0U else None
        self.min_freq = self.getDoubleParam("--min_freq")
        self.max_freq = self.getDoubleParam("--max_freq")
        self.self_estimation = self.checkParam("--selfEstimation")
        D = self.getDoubleParam("--defocus_range")
        if self.initial_defocus and not self.self_estimation:
            # reference bounds (ctf_estimate_from_psd.cpp:1699-1713)
            self.def_range = (max(1e3, def0U - D), min(150e3, def0U + D))
        else:
            self.def_range = (1e3, 100e3) if self.checkParam(
                "--defocus_range") else (2000.0, 40000.0)
        self.downsample_factor = self.getDoubleParam("--downSamplingPerformed")
        self.no_defocus = self.checkParam("--noDefocus")
        self.fast_defocus = None
        if self.checkParam("--fastDefocus"):
            self.fast_defocus = (self.getDoubleParam("--fastDefocus", 0),
                                 self.getDoubleParam("--fastDefocus", 1))
            if self.fast_defocus != (2.0, 10.0):
                raise XmippError(
                    ErrCode.ARG_INCORRECT,
                    "--fastDefocus takes only its defaults (2 10): the "
                    "ring demodulation of the fit has no regularisation "
                    "or Zernike size to set (ROADMAP.md §3 item 6)")
        self.refine_q0 = self.checkParam("--refine_amplitude_contrast")
        self.show_opt = self.checkParam("--show_optimization")
        self.radial_noise = self.checkParam("--radial_noise")
        self.enhance_weight = self.getDoubleParam("--enhance_weight")
        self.model_simpl = self.getIntParam("--model_simplification")
        self.n_bootstrap = self.getIntParam("--bootstrapFit")
        self.ctfmodel_size = self.getIntParam("--ctfmodelSize")
        f1 = self.getDoubleParam("--enhance_min_freq")
        f2 = self.getDoubleParam("--enhance_max_freq")
        self.enhance_f1 = f1 if f1 >= 0 else None
        self.enhance_f2 = f2 if f2 >= 0 else None

    def _estimator(self, psd_half, fast=False):
        return CTFEstimator(psd_half, self.Ts, self.kV, self.Cs, self.Q0,
                            Ca=self.Ca, min_freq=self.min_freq,
                            max_freq=self.max_freq,
                            defocus_range=self.def_range,
                            vpp_radius=self.vpp_radius, fast=fast,
                            enhance_weight=self.enhance_weight,
                            enhance_f1=self.enhance_f1,
                            enhance_f2=self.enhance_f2,
                            radial_noise=self.radial_noise,
                            model_simplification=self.model_simpl,
                            initial_defocus=self.initial_defocus,
                            no_defocus=self.no_defocus,
                            fast_defocus=self.fast_defocus,
                            refine_Q0=self.refine_q0,
                            show_optimization=self.show_opt,
                            device=self.device)

    def _estimate_1d(self, psd_half):
        return estimate_ctf_1d(psd_half, self.Ts, self.kV, self.Cs, self.Q0,
                               Ca=self.Ca, min_freq=self.min_freq,
                               max_freq=self.max_freq,
                               defocus_range=self.def_range,
                               device=self.device)

    def _finalize_ctf(self, ctf):
        """Refer the model to the original sampling rate (reference
        ctf_estimate_from_psd.cpp:2456: Tm /= downsampleFactor)."""
        if self.downsample_factor != 1.0:
            ctf.sampling_rate = self.Ts / self.downsample_factor
        return ctf

    def _write_ctfmodels(self, est, oroot):
        """<oroot>_ctfmodel_quadrant / _halfplane thumbnails: observed
        centered PSD with the fitted model substituted in one quadrant /
        half plane (reference ctfmodelSize outputs); the model is evaluated
        and resized on the card."""
        from xmipp3_tpu_torch.models.ctf_estimation import (_freq_grids,
                                                            _model_psd)
        from xmipp3_tpu_torch.ops.resize import spline_resize_2d
        size = self.ctfmodel_size
        n = est.n
        fy, fx = _freq_grids(n, est.Ts)
        model = _model_psd(torch.as_tensor(est.params, device=est.device),
                           as_tensor(fy, est.device), as_tensor(fx, est.device),
                           n, est.consts).cpu().numpy()
        obs_c = psd_half_to_full_centered(np.log1p(np.maximum(est.psd, 0)), n)
        mod_c = psd_half_to_full_centered(np.log1p(np.maximum(model, 0)), n)
        if size != n:
            both = spline_resize_2d(np.stack([obs_c, mod_c]), size, size,
                                    device=est.device).cpu().numpy()
            obs_c, mod_c = both[0], both[1]
        h = size // 2
        quad = obs_c.copy()
        quad[:h, h:] = mod_c[:h, h:]
        half = obs_c.copy()
        half[:h, :] = mod_c[:h, :]
        save_image(oroot + "_ctfmodel_quadrant.xmp", quad.astype(np.float32))
        save_image(oroot + "_ctfmodel_halfplane.xmp",
                   half.astype(np.float32))

    def _run_bootstrap(self, est, oroot):
        samples = est.bootstrap_fit(self.n_bootstrap)
        MetaData.fromRows([
            {"ctfDefocusU": float(u), "ctfDefocusV": float(v),
             "ctfDefocusAngle": float(a)} for u, v, a in samples
        ]).write(oroot + "_bootstrap.xmd")
        if self.verbose:
            print(f"bootstrap ({self.n_bootstrap}x): defU std="
                  f"{samples[:, 0].std():.1f} A  defV std="
                  f"{samples[:, 1].std():.1f} A  angle std="
                  f"{samples[:, 2].std():.2f} deg")

    def _fit_outputs(self, est, oroot):
        """The --ctfmodelSize thumbnails and the --bootstrapFit samples."""
        if self.checkParam("--ctfmodelSize"):
            self._write_ctfmodels(est, oroot)
        if self.n_bootstrap > 0:
            self._run_bootstrap(est, oroot)


class ProgCTFEstimateFromMicrograph(XmippProgram, _CTFFitMixin):
    name = "xmipp_ctf_estimate_from_micrograph"

    def defineParams(self):
        self.addUsageLine("Estimate the CTF from a micrograph: periodogram "
                          "PSD(s) + full model fit; single, per-region "
                          "(local defocus plane) or per-particle modes.")
        self.addParamsLine("   --micrograph <file> : Input micrograph")
        self.addParamsLine("     alias -i;")
        self.addParamsLine("  [--oroot <root=\"\">]  : Output rootname (default: micrograph name)")
        self.addParamsLine("  [--psd_estimator <method=periodogram>] : PSD "
                           "estimation method")
        self.addParamsLine("         where <method>")
        self.addParamsLine("                  periodogram")
        self.addParamsLine("                  ARMA : 2-D causal ARMA spectral model")
        self.addParamsLine("  [--pieceDim <d=512>] : Tile size for periodogram")
        self.addParamsLine("  [--overlap <o=0.5>]  : Tile overlap fraction")
        self.addParamsLine("  [--skipBorders <s=2>] : Border pieces to skip (regions mode)")
        self.addParamsLine("  [--Nsubpiece <N=1>]  : subdivide each piece "
                           "into NxN subpieces whose upsampled PSDs are "
                           "averaged (smoother PSD for small micrographs)")
        self.addParamsLine("  [--mode <mode=micrograph>] : How many PSDs/CTFs to estimate")
        self.addParamsLine("         where <mode>")
        self.addParamsLine("                  micrograph : single PSD for the whole micrograph")
        self.addParamsLine("                  regions <file=\"\"> : PSD+CTF per grid region, local defocus plane fit")
        self.addParamsLine("                  particles <file> : PSD+CTF per particle position (metadata with X/Y)")
        self.addParamsLine("  [--dont_estimate_ctf] : Only compute the PSD")
        self.addParamsLine("  [--acceleration1D]   : Use the fast 1-D radial fit")
        self._define_fit_params()
        from xmipp3_tpu_torch.parallel.cli import add_mesh_params
        add_mesh_params(self)

    def readParams(self):
        self.fn_mic = self.getParam("--micrograph")
        self.oroot = self.getParam("--oroot") if self.checkParam("--oroot") \
            else os.path.splitext(self.fn_mic)[0]
        self.piece = self.getIntParam("--pieceDim")
        self.overlap = self.getDoubleParam("--overlap")
        self.skip_borders = self.getIntParam("--skipBorders")
        self.n_subpiece = self.getIntParam("--Nsubpiece")
        self.estimator_kind = self.getParam("--psd_estimator")
        self.psd_mode = self.getParam("--mode")
        try:
            self.fn_pos = self.getParam("--mode", 1) \
                if self.psd_mode in ("regions", "particles") else ""
        except Exception:
            self.fn_pos = ""

        self.only_psd = self.checkParam("--dont_estimate_ctf")
        self.accel_1d = self.checkParam("--acceleration1D")
        self._read_fit_params()
        from xmipp3_tpu_torch.parallel.cli import read_mesh_params
        read_mesh_params(self)

    # -- helpers -----------------------------------------------------------
    def _psds_of_pieces(self, pieces: torch.Tensor) -> torch.Tensor:
        """Per-piece PSDs under the chosen estimator (half rfft layout) of
        a (B, piece, piece) tensor, on its device.

        --psd_estimator ARMA -> causal ARMA spectra (host float64, as in
        the reference); --Nsubpiece N>1 -> each piece's PSD is the average
        of the upsampled PSDs of its NxN subpieces (reference
        PSD_piece_by_averaging, ctf_estimate_from_micrograph.cpp:193-263)."""
        piece = pieces.shape[-1]
        dev = pieces.device
        if self.estimator_kind == "ARMA":
            from xmipp3_tpu_torch.ops.arma import causal_arma_psd
            out = []
            for pc in pieces.cpu().numpy():
                psd, _ = causal_arma_psd([pc], piece)
                out.append(psd[:, :piece // 2 + 1])
            return torch.as_tensor(np.stack(out).astype(np.float32),
                                   device=dev)
        if self.n_subpiece <= 1:
            return _piece_psds(pieces)
        from xmipp3_tpu_torch.ops.resize import spline_resize_2d
        N = self.n_subpiece
        small = max((2 * piece // N) & ~1, 8)
        step = (piece - small) // max(N - 1, 1)
        subs = []
        for i in range(N):
            for j in range(N):
                y0 = min(i * step, piece - small)
                x0 = min(j * step, piece - small)
                subs.append(pieces[:, y0:y0 + small, x0:x0 + small])
        sub_psds = _piece_psds(torch.cat(subs)).cpu().numpy()
        B = pieces.shape[0]
        acc = torch.zeros((B, piece, piece), dtype=torch.float32, device=dev)
        for k in range(N * N):
            blk = sub_psds[k * B:(k + 1) * B]
            cent = np.stack([psd_half_to_full_centered(b, small)
                             for b in blk])
            acc += spline_resize_2d(cent, piece, piece, device=dev)
        acc /= N * N
        out = torch.fft.ifftshift(acc, dim=(-2, -1))[:, :, :piece // 2 + 1]
        return out.contiguous()

    def _fit_one(self, psd_half, seed_params=None):
        """Full fit, or a short seeded refine for local pieces."""
        if self.accel_1d:
            return self._finalize_ctf(self._estimate_1d(psd_half)), 0.0
        est = self._estimator(psd_half, fast=seed_params is not None)
        if seed_params is None:
            ctf = est.estimate()
        else:
            # local refinement around the micrograph-level solution
            # (reference per-piece ROUT_Adjust_CTF seeded by the global fit)
            est.params = seed_params.copy()
            est._powell(STAGE_SETS["defocus"], maxiter=3)
            ctf = est.to_ctf()
        return self._finalize_ctf(ctf), est.final_fitness

    def _pca_criteria(self, psds: np.ndarray):
        """PSD-PCA quality criteria (reference :600-667): stdQ, first-PC
        projection variance, runs-test z of projection signs."""
        K, n = psds.shape[0], psds.shape[1]
        fy = np.fft.fftfreq(n)[:, None]
        fx = np.fft.rfftfreq(n)[None, :]
        w = np.sqrt(fy * fy + fx * fx)
        mask = (w > 0.05) & (w < 0.4)
        X = psds[:, mask].astype(np.float64)
        std = X.std(axis=0)
        avg = X.mean(axis=0)
        stdQ = float(np.median(std / np.maximum(avg, 1e-12)))
        Xs = (X - avg) / np.maximum(std, 1e-12)
        try:
            _, s, Vt = np.linalg.svd(Xs, full_matrices=False)
            p = Xs @ Vt[0]
        except np.linalg.LinAlgError:
            return stdQ, 0.0, 0.0
        pstd = float(p.std())
        return stdQ, pstd, _runs_test_z(np.sign(p))

    # -- modes ---------------------------------------------------------------
    def run(self):
        from xmipp3_tpu_torch.parallel.cli import (maybe_init_distributed,
                                                   resolve_mesh)
        from xmipp3_tpu_torch.parallel.mesh import world
        self.device = resolve_device(self.device_arg)
        started = maybe_init_distributed(self)
        try:
            self._mesh, _ = resolve_mesh(getattr(self, "mesh_mode", "auto"),
                                         device=self.device_arg)
            if self._mesh is not None:
                self.device = self._mesh.device
            self._writes = world()[1] == 0      # only rank 0 writes files
            with timed_phase("read micrograph"):
                mic = np.squeeze(Image(self.fn_mic).data).astype(np.float32)
                self._mic = as_tensor(mic, self.device)
            if self.psd_mode == "micrograph":
                self._run_micrograph(mic)
            elif self.psd_mode == "regions":
                self._run_regions(mic)
            else:
                self._run_particles(mic)
        finally:
            if started:
                torch.distributed.destroy_process_group()

    def _save(self, fn, data):
        if self._writes:
            save_image(fn, data)

    def _write_md(self, md, fn, **kw):
        if self._writes:
            md.write(fn, **kw)

    def _run_micrograph(self, mic):
        piece = min(self.piece, min(mic.shape))
        with timed_phase("psd"):
            pieces = gather_tiles(self._mic,
                                  tile_positions(mic.shape[0], piece,
                                                 self.overlap),
                                  tile_positions(mic.shape[1], piece,
                                                 self.overlap), piece)
            psds_d = self._psds_of_pieces(pieces)
            del pieces
            psd = psds_d.mean(dim=0).cpu().numpy()
        n = psd.shape[0]
        with timed_phase("write psd"):
            self._save(self.oroot + ".psd", psd_half_to_full_centered(psd, n))
        if self.only_psd:
            return
        with timed_phase("pca criteria"):
            psds = psds_d.cpu().numpy()
            del psds_d
            stdQ, pca1, zruns = self._pca_criteria(psds) if len(psds) > 2 \
                else (0.0, 0.0, 0.0)
        with timed_phase("fit"):
            if self.accel_1d:
                ctf, fitness = self._fit_one(psd)
            else:
                est = self._estimator(psd)
                ctf = self._finalize_ctf(est.estimate())
                fitness = est.final_fitness
                if self._writes:
                    self._fit_outputs(est, self.oroot)
        self.fitness = fitness
        md = ctf.to_metadata()
        oid = md.firstObject()
        md.setValue("ctfCritPsdStdQ", stdQ, oid)
        md.setValue("ctfCritPsdPCA1", pca1, oid)
        md.setValue("ctfCritPsdPCARuns", zruns, oid)
        md.row_format = True
        self._write_md(md, self.oroot + ".ctfparam", block="fullMicrograph")
        if self.verbose:
            print(f"DefocusU={ctf.defocusU:.1f} A  DefocusV="
                  f"{ctf.defocusV:.1f} A  angle={ctf.azimuthal_angle:.1f} "
                  f"deg  stdQ={stdQ:.3f} pcaRuns={zruns:.2f}")

    def _region_grid(self, mic):
        H, W = mic.shape
        piece = min(self.piece, min(H, W))
        nY = max(H // piece, 1)
        nX = max(W // piece, 1)
        s = self.skip_borders
        regions = []
        for i in range(nY):
            for j in range(nX):
                if nY > 2 * s and nX > 2 * s:
                    if i < s or i >= nY - s or j < s or j >= nX - s:
                        continue
                y0 = min(i * piece, H - piece)
                x0 = min(j * piece, W - piece)
                regions.append((y0, x0))
        return piece, regions

    def _run_regions(self, mic):
        piece, regions = self._region_grid(mic)
        with timed_phase("psd"):
            psds_d = self._psds_of_pieces(gather_pieces(
                self._mic, [r[0] for r in regions], [r[1] for r in regions],
                piece))
            psd_avg = psds_d.mean(dim=0).cpu().numpy()
            psds = psds_d.cpu().numpy()
        with timed_phase("write psd"):
            self._save(self.oroot + ".psd",
                       psd_half_to_full_centered(psd_avg, piece))
            self._save(self.oroot + ".psdstk",
                       np.stack([psd_half_to_full_centered(p, piece)
                                 for p in psds]))
        if self.only_psd:
            return
        # the global fit seeds the per-region local refinements
        with timed_phase("fit"):
            est = self._estimator(psd_avg)
            ctf_global = est.estimate()
        self.fitness = est.final_fitness
        seed = est.params
        rows = []
        defU, defV, xs, ys = [], [], [], []
        with timed_phase("refine"):
            if self.accel_1d:
                region_params = None
            else:
                # every region's seeded defocus refinement in one batched
                # compass; under --mesh the region axis is sharded over
                # the ranks
                fit_kw = dict(voltage=self.kV, Cs=self.Cs, Q0=self.Q0,
                              Ca=self.Ca, min_freq=self.min_freq,
                              max_freq=self.max_freq,
                              vpp_radius=self.vpp_radius)
                if self._mesh is not None:
                    from xmipp3_tpu_torch.parallel.engines import \
                        parallel_refine_defocus
                    region_params = parallel_refine_defocus(
                        self._mesh, psds, seed, self.Ts, **fit_kw)
                else:
                    from xmipp3_tpu_torch.models.ctf_estimation import \
                        refine_defocus_batch
                    region_params = refine_defocus_batch(
                        psds, seed, self.Ts, device=self.device, **fit_kw)
            for k, ((y0, x0), psd_i) in enumerate(zip(regions, psds)):
                if region_params is None:
                    ctf_i, _ = self._fit_one(psd_i, seed_params=seed)
                else:
                    est.params = region_params[k]
                    ctf_i = est.to_ctf()
                xc = (x0 + piece / 2) * self.Ts
                yc = (y0 + piece / 2) * self.Ts
                rows.append({"xcoor": x0 + piece // 2,
                             "ycoor": y0 + piece // 2,
                             "ctfDefocusU": ctf_i.defocusU,
                             "ctfDefocusV": ctf_i.defocusV,
                             "ctfDefocusAngle": ctf_i.azimuthal_angle})
                defU.append(ctf_i.defocusU)
                defV.append(ctf_i.defocusV)
                xs.append(xc)
                ys.append(yc)
        self._write_md(MetaData.fromRows(rows), self.oroot + "_regions.xmd")
        # local defocus plane fit (reference :470-560)
        xs, ys = np.asarray(xs), np.asarray(ys)
        coefU = fit_defocus_plane(xs, ys, np.asarray(defU))
        coefV = fit_defocus_plane(xs, ys, np.asarray(defV))
        H, W = mic.shape
        xc, yc = W / 2 * self.Ts, H / 2 * self.Ts
        ctf_global.defocusU = float(coefU[0] + coefU[1] * xc + coefU[2] * yc)
        ctf_global.defocusV = float(coefV[0] + coefV[1] * xc + coefV[2] * yc)
        md = ctf_global.to_metadata()
        oid = md.firstObject()
        for lbl, v in (("ctfDefocusPlaneUA", coefU[0]),
                       ("ctfDefocusPlaneUB", coefU[1]),
                       ("ctfDefocusPlaneUC", coefU[2]),
                       ("ctfDefocusPlaneVA", coefV[0]),
                       ("ctfDefocusPlaneVB", coefV[1]),
                       ("ctfDefocusPlaneVC", coefV[2])):
            md.setValue(lbl, float(v), oid)
        md.row_format = True
        self._write_md(md, self.oroot + ".ctfparam", block="fullMicrograph")
        if self.verbose:
            print(f"regions={len(regions)}  plane defU(x,y) = "
                  f"{coefU[0]:.1f} + {coefU[1]:.3g} x + {coefU[2]:.3g} y")

    def _run_particles(self, mic):
        md = MetaData(self.fn_pos)
        piece = min(self.piece, min(mic.shape))
        H, W = mic.shape
        y0s, x0s, ids = [], [], []
        for oid in md:
            row = md.getRow(oid)
            x = int(float(row.get("xcoor", row.get("X", 0))))
            y = int(float(row.get("ycoor", row.get("Y", 0))))
            y0s.append(int(np.clip(y - piece // 2, 0, H - piece)))
            x0s.append(int(np.clip(x - piece // 2, 0, W - piece)))
            ids.append(oid)
        with timed_phase("psd"):
            psds_d = self._psds_of_pieces(gather_pieces(self._mic, y0s, x0s,
                                                        piece))
            psd_avg = psds_d.mean(dim=0).cpu().numpy()
            psds = psds_d.cpu().numpy()
        with timed_phase("write psd"):
            self._save(self.oroot + ".psdstk",
                       np.stack([psd_half_to_full_centered(p, piece)
                                 for p in psds]))
        if self.only_psd:
            return
        with timed_phase("fit"):
            est = self._estimator(psd_avg)
            est.estimate()
        self.fitness = est.final_fitness
        seed = est.params
        with timed_phase("refine"):
            if self.accel_1d:
                particle_params = None
            else:
                from xmipp3_tpu_torch.models.ctf_estimation import \
                    refine_defocus_batch
                particle_params = refine_defocus_batch(
                    psds_d, seed, self.Ts, self.kV, self.Cs, self.Q0,
                    Ca=self.Ca, min_freq=self.min_freq,
                    max_freq=self.max_freq, vpp_radius=self.vpp_radius)
            ctfs = []
            for k in range(len(ids)):
                if particle_params is None:
                    ctf_i, _ = self._fit_one(psds[k], seed_params=seed)
                else:
                    est.params = particle_params[k]
                    ctf_i = est.to_ctf()
                ctfs.append(ctf_i)
        with timed_phase("write outputs"):
            for k, (oid, ctf_i) in enumerate(zip(ids, ctfs)):
                fn_i = f"{self.oroot}_particle{k + 1:04d}.ctfparam"
                if self._writes:
                    ctf_i.write(fn_i)
                md.setValue("ctfModel", fn_i, oid)
                md.setValue("psd", f"{k + 1:06d}@{self.oroot}.psdstk", oid)
            self._write_md(md, self.oroot + "_particles.xmd")
        if self.verbose:
            print(f"fitted {len(ids)} particle CTFs")


class ProgCTFEstimateFromPSD(XmippProgram, _CTFFitMixin):
    name = "xmipp_ctf_estimate_from_psd"

    def defineParams(self):
        self.addUsageLine("Adjust a parametric CTF model to a PSD.")
        self.addParamsLine("   --psd <file>  : PSD image (centered full plane)")
        self.addParamsLine("     alias -i;")
        self.addParamsLine("  [-o <ctfparam=\"\">] : Output .ctfparam")
        self._define_fit_params()

    def readParams(self):
        self.fn_psd = self.getParam("--psd")
        self.fn_out = self.getParam("-o") if self.checkParam("-o") else \
            os.path.splitext(self.fn_psd)[0] + ".ctfparam"
        self._read_fit_params()

    def _load_half(self):
        full = np.squeeze(Image(self.fn_psd).data).astype(np.float32)
        n = full.shape[0]
        unshift = np.fft.ifftshift(full)
        return np.ascontiguousarray(unshift[:, : n // 2 + 1])

    def run(self):
        self.device = resolve_device(self.device_arg)
        with timed_phase("fit"):
            est = self._estimator(self._load_half())
            ctf = self._finalize_ctf(est.estimate())
        self.fitness = est.final_fitness
        ctf.write(self.fn_out)
        self._fit_outputs(est, os.path.splitext(self.fn_out)[0])
        if self.verbose:
            print(f"DefocusU={ctf.defocusU:.1f} A  DefocusV="
                  f"{ctf.defocusV:.1f} A  angle={ctf.azimuthal_angle:.1f} deg")


class ProgCTFEstimateFromPSDFast(ProgCTFEstimateFromPSD):
    """1-D radial-average CTF fit (reference ctf_estimate_from_psd_fast —
    a distinct isotropic algorithm, NOT an alias of the 2-D fit)."""
    name = "xmipp_ctf_estimate_from_psd_fast"

    def run(self):
        self.device = resolve_device(self.device_arg)
        with timed_phase("fit"):
            ctf = self._estimate_1d(self._load_half())
        self._finalize_ctf(ctf).write(self.fn_out)
        if self.verbose:
            print(f"Defocus={ctf.defocusU:.1f} A (1-D radial fit)")


PROGRAM = None  # registered individually
