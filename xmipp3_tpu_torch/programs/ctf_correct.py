"""CTF correction programs: ctf_phase_flip and ctf_correct_wiener2d, on
the card.

Contracts: reference ctf_phase_flip.{h,cpp} and ctf_correct_wiener2d, with
the flags and outputs of the reference package's programs
(programs/ctf_correct.py). Both are XmippMetadataPrograms: a stack, an
image or a metadata in, a stack or metadata out. With --ctf one CTF
filters every image; otherwise each row's own CTF (inline ctf* labels or a
ctfModel file) filters its image, and a batch's per-row CTFs are evaluated
in one pass (ops.ctf.generate_2d_rows) where the reference evaluates them
one image at a time.

Not yet ported: ctf_group, ctf_sort_psds and ctf_enhance_psd (they need the
PSD module; ROADMAP.md, port queue).
"""
from __future__ import annotations

import copy

import torch

from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
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


PROGRAM = ProgCTFPhaseFlip
