"""xmipp_image_operate — arithmetic on images/stacks, on the card.

Contract: the reference package's programs/image_operate.py (reference
reconstruction/image_operate.{h,cpp} binary/unary op set). Every batch
goes to the program's device (--device; the card by default) and the
operation runs there in float32, as the reference runs it in numpy
float32; division by zero and logs of zero give 0, as there.

A stack operand is broadcast against each batch as the reference
broadcasts it, except that an operand with one image per input image is
taken row by row (the reference broadcasts such an operand against its
whole batch, which works only when the input fits in one batch).
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image
from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram

_BINARY = {"plus": torch.add, "minus": torch.sub, "mult": torch.mul,
           "divide": torch.div, "min": torch.minimum, "max": torch.maximum,
           "dot_product": None}
_UNARY = {"sqrt": torch.sqrt, "abs": torch.abs, "log": torch.log,
          "log10": torch.log10, "exp": torch.exp, "square": torch.square,
          "pow": None, "reset": None, "radial_avg": None}


class ProgImageOperate(XmippMetadataProgram):
    name = "xmipp_image_operate"

    def defineProcessParams(self):
        self.addUsageLine("Apply arithmetic operations to images.")
        self.addParamsLine("== Binary operations ==")
        self.addParamsLine("[--plus <file_or_value>]   : Add")
        self.addParamsLine("[--minus <file_or_value>]  : Subtract")
        self.addParamsLine("[--mult <file_or_value>]   : Multiply")
        self.addParamsLine("[--divide <file_or_value>] : Divide")
        self.addParamsLine("[--min <file_or_value>]    : Minimum")
        self.addParamsLine("[--max <file_or_value>]    : Maximum")
        self.addParamsLine("== Unary operations ==")
        self.addParamsLine("[--sqrt]    : Square root")
        self.addParamsLine("[--abs]     : Absolute value")
        self.addParamsLine("[--log]     : Natural log")
        self.addParamsLine("[--log10]   : Log10")
        self.addParamsLine("[--exp]     : Exponential")
        self.addParamsLine("[--square]  : Square")
        self.addParamsLine("[--pow <value=2>] : Power")
        self.addParamsLine("[--reset]   : Set to zero")

    def readProcessParams(self):
        self.op = None
        self.operand = None
        for name in _BINARY:
            if self.checkParam("--" + name):
                self.op = name
                arg = self.getParam("--" + name)
                try:
                    self.operand = float(arg)
                except ValueError:
                    self.operand = np.squeeze(Image.read_stack(arg))
                break
        if self.op is None:
            for name in _UNARY:
                if self.checkParam("--" + name):
                    self.op = name
                    if name == "pow":
                        self.operand = self.getDoubleParam("--pow")
                    break
        if self.op is None:
            raise XmippError(ErrCode.ARG_MISSING, "an operation is required")

    def preProcess(self):
        self._row = 0           # the first input row of the next batch
        self._n_rows = self.mdIn.size()

    def _operand(self, n: int, ndim: int):
        """The binary operand for the next n rows: a tensor on the device
        that broadcasts against the (n, ...) batch."""
        o = self.operand
        if not isinstance(o, np.ndarray):
            return torch.tensor(o, dtype=torch.float32, device=self.device)
        if o.ndim == ndim and len(o) == self._n_rows and self._n_rows > 1:
            o = o[self._row:self._row + n]
        elif o.ndim == ndim - 1:
            o = o[None]
        return torch.as_tensor(np.ascontiguousarray(o, np.float32),
                               device=self.device)

    def processBatch(self, imgs, rows):
        x = torch.as_tensor(imgs, device=self.device)
        op = self.op
        try:
            if op in _BINARY:
                out = _BINARY[op](x, self._operand(len(rows), x.ndim))
            elif op == "pow":
                return torch.pow(x, self.operand)
            elif op == "reset":
                return torch.zeros_like(x)
            else:
                out = _UNARY[op](x)
        finally:
            self._row += len(rows)
        return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


PROGRAM = ProgImageOperate
