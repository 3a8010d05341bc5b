"""Typed error system, equivalent of the reference's XmippError/REPORT_ERROR.

Reference behavior: core/xmipp_error.h defines ~60 ERR_* codes; programs raise
XmippError(code, msg) and XmippProgram.tryRun() catches it, prints, and returns
nonzero (see the reference's applications/programs/*/…_main.cpp pattern).
"""
from __future__ import annotations

import enum


class ErrCode(enum.Enum):
    ARG_BADCMDLINE = "Bad command line"
    ARG_INCORRECT = "Incorrect argument"
    ARG_MISSING = "Missing argument"
    DEBUG_TEST = "Debug/test error"
    GRID_SIZE = "Incorrect grid size"
    IMG_NOREAD = "Cannot read image"
    IMG_NOWRITE = "Cannot write image"
    IMG_UNKNOWN = "Unknown image type"
    INDEX_OUTOFBOUNDS = "Index out of bounds"
    IO_NOTEXIST = "File does not exist"
    IO_NOTOPEN = "File cannot be opened"
    IO_NOTFILE = "Not a file"
    IO_SIZE = "Incorrect file size"
    MD_BADLABEL = "Unknown metadata label"
    MD_MISSINGLABEL = "Missing metadata label"
    MD_NOACTIVE = "No active metadata object"
    MD_BADBLOCK = "Missing metadata block"
    MATRIX_DIM = "Incorrect matrix dimension"
    MULTIDIM_DIM = "Incorrect multidim dimension"
    MULTIDIM_SIZE = "Incorrect multidim size"
    NUMERICAL = "Numerical error"
    NOT_IMPLEMENTED = "Not implemented"
    PARAM_INCORRECT = "Incorrect parameter"
    VALUE_INCORRECT = "Incorrect value"
    UNCLASSIFIED = "Unclassified error"


class XmippError(Exception):
    """Typed framework error; carries an ErrCode plus a free-form message."""

    def __init__(self, code: ErrCode, msg: str = ""):
        self.code = code
        self.msg = msg
        super().__init__(f"{code.name}: {code.value}. {msg}".strip())


def report_error(code: ErrCode, msg: str = "") -> None:
    raise XmippError(code, msg)
