"""PSD programs of the reference package's programs/resolution_dir.py:
xmipp_ctf_estimate_psd_with_arma (the 2-D causal ARMA spectral model, host
float64 as in the reference) and xmipp_psd_estimate (averaged overlapping
periodograms, the patches transformed on the card unless `--device cpu`
is given).

The module's other programs (resolution_directional,
classify_CL2D_core_analysis, angular_accuracy_pca) are still to be ported
(ROADMAP.md, port queue items 7-8).
"""
from __future__ import annotations

import numpy as np

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase


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


PROGRAM = None  # registered individually
