"""xmippLib on the port: the reference's Python binding for scripts.

The reference exposes a C-extension `xmippLib` (bindings/python/
xmippmodule.cpp:1524-1531: types FileName, Image, MDQuery, MetaData, Program,
SymList, FourierProjector + ~60 free functions and MDL_* label constants).
Scripts written against it (applications/scripts/*, the test harness
tests/test.py:174-200 comparators) import this module unchanged for the
covered surface; label constants are carried as their STAR string names
(scripts treat them opaquely).

Files, metadata, labels and symmetry stay on the host (numpy, pandas).
The projector, readApplyGeo, the CTF functions, the alignment and the
preview filters run on the card unless `device="cpu"` is given, and raise
when no card is visible; images come back to the host as numpy.
"""
from __future__ import annotations

import os as _os
from functools import lru_cache as _lru_cache

import numpy as _np
import torch as _torch

from xmipp3_tpu_torch.core.filename import FileName as _FileName
from xmipp3_tpu_torch.core.funcs import compare_two_files
from xmipp3_tpu_torch.core.image import Image as _CoreImage
from xmipp3_tpu_torch.core.metadata import (MetaData as _CoreMetaData,
                                            compare_two_metadata_files)
from xmipp3_tpu_torch.core.labels import LABELS as _LABELS
from xmipp3_tpu_torch.core.sym import SymList as _CoreSymList
from xmipp3_tpu_torch.device import as_tensor as _as_tensor


def _host(t):
    """A tensor's values as numpy on the host."""
    return t.detach().cpu().numpy()


class _CardGraph:
    """fn on the card as one CUDA graph, captured at the shapes of
    `inputs` (device tensors, copied into the graph's input buffers) and
    replayed with new values copied into the same buffers; returns the
    graph's output tensors, which the next replay overwrites.

    The binding is called one image at a time, as a script's loop calls
    it, where the port's ops are written for batches: a projection
    launches about 70 small kernels, readApplyGeo about 130 and
    image_align about 4,000, each paying the host's launch cost. A replay
    launches them all at once. fn must not read device values on the host
    (no .item(), no data-dependent shapes); the runs before the capture
    build its cached tables and FFT plans."""

    def __init__(self, fn, *inputs):
        self.inputs = [x.clone() for x in inputs]
        side = _torch.cuda.Stream()
        side.wait_stream(_torch.cuda.current_stream())
        with _torch.cuda.stream(side):
            for _ in range(2):
                fn(*self.inputs)
        _torch.cuda.current_stream().wait_stream(side)
        self.graph = _torch.cuda.CUDAGraph()
        # thread_local: the capture does not forbid other threads' CUDA
        # calls (a script's loader thread, say)
        with _torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.output = fn(*self.inputs)

    def __call__(self, *values):
        for buf, v in zip(self.inputs, values):
            buf.copy_(_torch.as_tensor(v))
        self.graph.replay()
        return self.output


def _align_one(ref, mov):
    from xmipp3_tpu_torch.ops.align import align_considering_mirrors
    return align_considering_mirrors(ref, mov)[5]


@_lru_cache(maxsize=8)
def _card_graph(fn, device, *shapes):
    """The graph of `fn` for float32 inputs of `shapes` on `device`,
    captured once."""
    return _CardGraph(fn, *(_torch.zeros(s, device=device) for s in shapes))


# ---------------------------------------------------------------------------
# MDL label constants (string-valued; accepted by MetaData methods)
# ---------------------------------------------------------------------------

def _const_name(label: str) -> str:
    out = ["MDL_"]
    prev_lower = False
    for ch in label:
        if ch.isupper() and prev_lower:
            out.append("_")
        out.append(ch.upper())
        prev_lower = ch.islower()
    return "".join(out).replace("__", "_")


_EXPLICIT = {
    "image": "MDL_IMAGE", "imageRef": "MDL_IMAGE_REF",
    "imageOriginal": "MDL_IMAGE_ORIGINAL", "itemId": "MDL_ITEM_ID",
    "gatherId": "MDL_GATHER_ID", "enabled": "MDL_ENABLED",
    "angleRot": "MDL_ANGLE_ROT", "angleTilt": "MDL_ANGLE_TILT",
    "anglePsi": "MDL_ANGLE_PSI", "shiftX": "MDL_SHIFT_X",
    "shiftY": "MDL_SHIFT_Y", "shiftZ": "MDL_SHIFT_Z", "flip": "MDL_FLIP",
    "ref": "MDL_REF", "ref3d": "MDL_REF3D", "maxCC": "MDL_MAXCC",
    "cost": "MDL_COST", "weight": "MDL_WEIGHT", "xcoor": "MDL_XCOOR",
    "ycoor": "MDL_YCOOR", "zcoor": "MDL_ZCOOR",
    "micrograph": "MDL_MICROGRAPH", "micrographId": "MDL_MICROGRAPH_ID",
    "sampling_rate": "MDL_SAMPLINGRATE", "ctfModel": "MDL_CTF_MODEL",
    "ctfDefocusU": "MDL_CTF_DEFOCUSU", "ctfDefocusV": "MDL_CTF_DEFOCUSV",
    "ctfDefocusAngle": "MDL_CTF_DEFOCUS_ANGLE",
    "ctfVoltage": "MDL_CTF_VOLTAGE", "ctfQ0": "MDL_CTF_Q0",
    "ctfSphericalAberration": "MDL_CTF_CS",
    "ctfSamplingRate": "MDL_CTF_SAMPLING_RATE",
    "classCount": "MDL_CLASS_COUNT", "count": "MDL_COUNT",
    "order_": "MDL_ORDER", "resolutionFreq": "MDL_RESOLUTION_FREQ",
    "resolutionFRC": "MDL_RESOLUTION_FRC",
    "resolutionFreqReal": "MDL_RESOLUTION_FREQREAL",
    "neighbor": "MDL_NEIGHBOR", "symmetry": "MDL_SYMMETRY",
}

_name_to_label = {}
for _label in _LABELS:
    _const = _EXPLICIT.get(_label, _const_name(_label))
    globals()[_const] = _label
    _name_to_label[_const] = _label
MDL_UNDEFINED = ""


def label2Str(label) -> str:
    return str(label)


def str2Label(s: str) -> str:
    return s


def labelType(label):
    from xmipp3_tpu_torch.core.labels import label_type
    return label_type(str(label)).value


def isValidLabel(label) -> bool:
    return str(label) in _LABELS


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

class FileName(str):
    def compose(self, prefix, path=None, ext=None):
        """Reference compose forms: (root, number, ext) -> root000001.ext;
        (number, path) -> 000001@path; (block, path) -> block@path. The
        reference binding mutates in place; str is immutable in Python, so
        the composed name is RETURNED (callers must take the result)."""
        if ext is not None:
            return FileName(f"{prefix}{int(path):06d}.{ext}")
        if path is None:
            return FileName(str(prefix))
        if isinstance(prefix, int):
            return FileName(f"{prefix:06d}@{path}")
        return FileName(f"{prefix}@{path}")

    def isMetaData(self):
        from xmipp3_tpu_torch.core.metadata_program import is_metadata_file
        return is_metadata_file(str(self))

    def exists(self):
        return _FileName(str(self)).exists()

    def getExtension(self):
        return _FileName(str(self)).ext

    def removeBlockName(self):
        return FileName(_FileName(str(self)).path)

    def getBlockName(self):
        return _FileName(str(self)).block or ""

    def isInStack(self):
        return _FileName(str(self)).slice_index is not None


class Image:
    DT_FLOAT = "float32"

    def __init__(self, filename=None):
        self._img = _CoreImage()
        if filename is not None:
            self.read(filename)

    def read(self, filename, header_only=False):
        self._img.read(str(filename), header_only=header_only)
        return self

    def readApplyGeo(self, filename, md=None, objId=None, device=None):
        """Read + apply the row's 2-D registration geometry, reference
        readApplyGeo semantics (ops/geo.read_apply_geo on `device`, the
        card by default, as one CUDA graph there; psi/shift/flip pulled
        from the metadata row when given)."""
        self.read(filename)
        if md is None or objId is None:
            return self
        from xmipp3_tpu_torch.device import resolve_device
        from xmipp3_tpu_torch.ops.geo import read_apply_geo
        dev = resolve_device(device)
        row = md.getRow(objId) if hasattr(md, "getRow") else md
        data = _np.asarray(self._img.data, _np.float32)[None]
        args = [_np.array([float(row.get(k, 0.0) or 0.0)], _np.float32)
                for k in ("anglePsi", "shiftX", "shiftY")]
        args.append(_np.array([bool(row.get("flip", False))]))
        if dev.type == "cuda":     # flip rides in a float buffer
            out = _card_graph(read_apply_geo, dev, data.shape,
                              *(a.shape for a in args))(data, *args)
        else:
            out = read_apply_geo(*(_as_tensor(a, dev, None)
                                   for a in (data, *args)))
        self._img = _CoreImage(_host(out)[0])
        return self

    def convertPSD(self):
        """In-place xmipp2PSD: 10*log10(1+PSD), centered (reference
        Image convertPSD binding, xmippmodule.cpp:1169-1193 area)."""
        d = _np.asarray(self._img.data, _np.float64)
        d = _np.fft.fftshift(10.0 * _np.log10(1.0 + _np.abs(d)))
        self._img = _CoreImage(d.astype(_np.float32))

    def write(self, filename):
        self._img.write(str(filename))

    def getData(self):
        return self._img.data

    def setData(self, data):
        self._img = _CoreImage(_np.asarray(data, _np.float32))

    def getDimensions(self):
        return self._img.getDimensions()

    def equal(self, other, tolerance=1e-3):
        return self._img.equal(other._img if isinstance(other, Image)
                               else _CoreImage(other), tolerance)

    def computeStats(self):
        d = self._img.data
        return (float(d.mean()), float(d.std()), float(d.min()),
                float(d.max()))

    def getPixel(self, *idx):
        return float(self._img.data[tuple(int(i) for i in idx)])

    def setDataType(self, dt):
        pass

    def resize(self, *dims):
        self._img = _CoreImage(_np.zeros(tuple(int(d) for d in dims[::-1]),
                                         _np.float32))

    def applyCTF(self, ctfparam, Ts, absPhase=False, device=None):
        """Multiply by the damped CTF of a .ctfparam at sampling Ts, on
        `device` (the card by default)."""
        from xmipp3_tpu_torch.ops.ctf import CTFDescription, apply_ctf
        ctf = CTFDescription.from_metadata(str(ctfparam))
        ctf.sampling_rate = Ts
        self._img = _CoreImage(
            _host(apply_ctf(self._img.data, ctf, absPhase, device=device)))

    def __add__(self, other):
        out = Image()
        out.setData(self._img.data + (other._img.data if isinstance(
            other, Image) else other))
        return out

    def inplaceAdd(self, other):
        self.setData(self._img.data + (other._img.data if isinstance(
            other, Image) else other))


class MetaData(_CoreMetaData):
    def __init__(self, filename=None):
        if filename is not None and not isinstance(filename,
                                                   (_CoreMetaData, MetaData)):
            super().__init__(str(filename))
        elif isinstance(filename, _CoreMetaData):
            super().__init__(filename.df)
        else:
            super().__init__()

    def read(self, filename, *a, **kw):  # type: ignore[override]
        return super().read(str(filename))

    def write(self, filename, *a, **kw):  # type: ignore[override]
        return super().write(str(filename))

    def getValue(self, label, objId):
        return super().getValue(str(label), objId)

    def setValue(self, label, value, objId):
        return super().setValue(str(label), value, objId)

    def containsLabel(self, label):
        return super().containsLabel(str(label))

    # -- reference binding surface (tests/test_binding.py contracts) ------
    def __eq__(self, other):
        if not isinstance(other, _CoreMetaData):
            return NotImplemented
        a, b = self.df, other.df
        if sorted(a.columns) != sorted(b.columns) or len(a) != len(b):
            return False
        for col in a.columns:
            x = a[col].to_numpy()
            y = b[col].to_numpy()
            if x.dtype.kind in "fiu" and y.dtype.kind in "fiu":
                if not _np.allclose(x.astype(float), y.astype(float),
                                    rtol=1e-5, atol=1e-6):
                    return False
            elif not all(" ".join(str(u).split()) == " ".join(str(v).split())
                         for u, v in zip(x, y)):
                return False
        return True

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None

    def importObjects(self, other, query=None):
        """Copy the rows of `other` that satisfy `query` (MDValueEQ etc.)."""
        df = other.df
        if query is not None:
            df = df[query.mask(df)]
        self._df = df.reset_index(drop=True).copy()

    def operate(self, expression: str):
        """In-place column arithmetic, e.g. "angleRot=3*angleRot,
        anglePsi=2*anglePsi" (reference MDSql operate contract)."""
        for stmt in expression.split(","):
            target, expr = (t.strip() for t in stmt.split("=", 1))
            self._df[target] = self._df.eval(expr)

    def joinNatural(self, md1, md2):
        """Natural join on all shared columns (reference joinNatural)."""
        import pandas as pd
        common = [c for c in md1.df.columns if c in md2.df.columns]
        self._df = pd.merge(md1.df, md2.df, on=common).reset_index(drop=True)

    def intersection(self, other, label):
        """Keep rows whose `label` value appears in `other` (in place)."""
        label = str(label)
        keep = self._df[label].isin(set(other.df[label]))
        self._df = self._df[keep].reset_index(drop=True)

    def fillConstant(self, label, value):
        return super().fillConstant(str(label), value)

    def removeLabel(self, label):
        return super().removeLabel(str(label))


def existsBlockInMetaDataFile(path) -> bool:
    """True if "block@file" names an existing block (reference helper)."""
    from xmipp3_tpu_torch.core.filename import as_filename
    fn = as_filename(str(path))
    if fn.block is None:
        return _os.path.exists(fn.path)
    if not _os.path.exists(fn.path):
        return False
    return fn.block in _CoreMetaData.blocksInFile(fn.path)


class MDQuery:
    def __init__(self, expr: str = ""):
        self.expr = expr

    def mask(self, df):
        return df.eval(self.expr)


class MDValueEQ(MDQuery):
    def __init__(self, label, value):
        self.label = str(label)
        self.value = value

    def mask(self, df):
        if self.label not in df.columns:
            return _np.zeros(len(df), bool)
        return df[self.label] == self.value


class MDValueRange(MDQuery):
    def __init__(self, label, vmin, vmax):
        self.label = str(label)
        self.vmin, self.vmax = vmin, vmax

    def mask(self, df):
        col = df[self.label]
        return (col >= self.vmin) & (col <= self.vmax)


class SymList:
    def __init__(self, sym: str = "c1"):
        self._s = _CoreSymList(sym)

    def readSymmetryFile(self, sym):
        self._s = _CoreSymList(str(sym))

    def getSymmetryMatrices(self, sym=None):
        s = self._s if sym is None else _CoreSymList(str(sym))
        return [m.tolist() for m in s.sym_matrices()]

    def getTrueSymsNo(self):
        return self._s.true_sym_no

    def computeDistance(self, md, projdir_mode=False, check_mirrors=True,
                        object_rotation=False):
        raise NotImplementedError


class FourierProjector:
    """Pad and Fourier-transform a volume once on `device` (the card by
    default), then project it at one direction a call (one CUDA graph a
    call on the card)."""

    def __init__(self, volume, padding=2.0, max_freq=0.5, spline_degree=1,
                 device=None):
        from xmipp3_tpu_torch.ops.project import FourierProjector as _FP
        data = volume.getData() if isinstance(volume, Image) else \
            _np.asarray(volume)
        self._p = _FP(_np.squeeze(data), pad_factor=padding, device=device)
        self._graph = None

    def _project(self, mats):
        """ops.project.FourierProjector.project_euler at a device tensor
        of Euler matrices."""
        from xmipp3_tpu_torch.ops.project import (extract_central_slices,
                                                  slices_to_projections)
        return slices_to_projections(
            extract_central_slices(self._p.vf, mats, self._p.N), self._p.N)

    def projectVolume(self, rot, tilt, psi):
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        mats = _np.asarray(euler_matrix([rot], [tilt], [psi]), _np.float32)
        if self._p.device.type == "cuda":
            if self._graph is None:
                self._graph = _CardGraph(self._project,
                                         _as_tensor(mats, self._p.device))
            views = self._graph(mats)
        else:
            views = self._project(_as_tensor(mats, self._p.device))
        img = Image()
        img.setData(_host(views)[0])
        return img


DT_FLOAT = "float32"
DT_DOUBLE = "float64"
DT_INT = "int32"
DT_UCHAR = "uint8"


def projectVolumeDouble(vol, rot, tilt, psi, device=None):
    """Real-space projection (reference projectVolumeDouble binding) on
    `device`, the card by default."""
    from xmipp3_tpu_torch.ops.project import project_real_space
    data = vol.getData() if isinstance(vol, Image) else _np.asarray(vol)
    img = Image()
    img.setData(_host(project_real_space(
        _np.squeeze(data).astype(_np.float32), [rot], [tilt], [psi],
        device=device))[0])
    return img


class Program:
    """Param-DSL access for XmippScript (bindings/python/xmipp_base.py:52)."""

    def __init__(self, runWithoutArgs=False):
        from xmipp3_tpu_torch.core.program import XmippProgram as _P
        self._p = _P()

    def addUsageLine(self, line, verbatim=False):
        self._p.addUsageLine(line, verbatim)

    def addParamsLine(self, line):
        self._p.addParamsLine(line)

    def addExampleLine(self, line, verbatim=True):
        self._p.addExampleLine(line, verbatim)

    def read(self, argv):
        """Parse argv; returns False when only help was requested
        (xmipp_base.XmippScript.tryRun gates run() on this)."""
        self._p.read(list(argv))
        return not getattr(self._p, "_help_requested", False)

    def checkParam(self, name):
        return self._p.checkParam(name)

    def getParam(self, name, idx=0):
        return self._p.getParam(name, idx)

    def getListParam(self, name):
        return self._p.getListParam(name)


# ---------------------------------------------------------------------------
# free functions (most used by scripts/tests)
# ---------------------------------------------------------------------------

def compareTwoFiles(fn1, fn2, offset=0):
    return compare_two_files(str(fn1), str(fn2), int(offset))


def compareTwoMetadataFiles(fn1, fn2):
    return compare_two_metadata_files(str(fn1), str(fn2))


def compareTwoImageTolerance(fn1, fn2, tolerance=1e-3):
    a = _CoreImage(str(fn1))
    b = _CoreImage(str(fn2))
    return a.equal(b, tolerance)


def getImageSize(filename):
    img = _CoreImage()
    img.read(str(filename), header_only=True)
    n, z, y, x = img.header.shape
    return (x, y, z, n)


def getBlocksInMetaDataFile(filename):
    return _CoreMetaData.blocksInFile(str(filename))


def createEmptyFile(filename, xdim, ydim, zdim=1, ndim=1):
    from xmipp3_tpu_torch.core.image import save_image
    shape = ([ndim] if ndim > 1 else []) + \
        ([zdim] if zdim > 1 else []) + [ydim, xdim]
    save_image(str(filename), _np.zeros(shape, _np.float32))


def activateMathExtensions():
    pass


def Euler_angles2matrix(rot, tilt, psi):
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    return _np.asarray(euler_matrix(rot, tilt, psi))


def Euler_matrix2angles(A):
    from xmipp3_tpu_torch.core.geometry import matrix_to_euler
    return matrix_to_euler(_np.asarray(A))


def Euler_direction(rot, tilt, psi):
    return Euler_angles2matrix(rot, tilt, psi)[2]


def gaussian1D(x, sigma, mu=0.0):
    return _np.exp(-0.5 * ((x - mu) / sigma) ** 2) / (
        sigma * _np.sqrt(2 * _np.pi))


def _ctf_of(md):
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    return CTFDescription.from_metadata(md)


def errorBetween2CTFs(md1, md2, Xdim=256, minFreq=0.05, maxFreq=0.25,
                      device=None):
    """Sum over the Xdim^2 Fourier grid of |CTF2 - CTF1| (pure, no damping)
    within the [minFreq, maxFreq]/Tm annulus — the reference
    errorBetween2CTFs (data/ctf.cpp:107); golden 5045.79 for the binding
    test's parameter pair at Xdim=256. The CTFs are evaluated on
    `device`, the card by default."""
    from xmipp3_tpu_torch.ops.ctf import error_between_2ctfs
    return error_between_2ctfs(_ctf_of(md1), _ctf_of(md2), int(Xdim),
                               minFreq, maxFreq, device=device)


def errorMaxFreqCTFs(md1, phaseRad=_np.pi / 2):
    """Resolution (A) where the astigmatic phase difference reaches
    phaseRad: 1/sqrt(phaseRad / (K1 |dfU - dfV|)) (data/ctf.cpp); host
    float64 arithmetic on the parameters."""
    from xmipp3_tpu_torch.ops.ctf import error_max_freq_ctfs
    return error_max_freq_ctfs(_ctf_of(md1), phaseRad)


def errorMaxFreqCTFs2D(md1, md2, Xdim=256, phaseRad=_np.pi / 2,
                       device=None):
    """Resolution (A) up to which two CTFs agree in phase within phaseRad:
    the fraction of grid points with |chi1 - chi2| < phaseRad converts to a
    max agreeing frequency (data/ctf.cpp errorMaxFreqCTFs2D). The phase
    arguments are evaluated on `device`, the card by default."""
    from xmipp3_tpu_torch.ops.ctf import error_max_freq_ctfs_2d
    return error_max_freq_ctfs_2d(_ctf_of(md1), _ctf_of(md2), int(Xdim),
                                  phaseRad, device=device)


# ---------------------------------------------------------------------------
# Label tags (reference metadata_label.h TAGLABEL_* + MDL::labelHasTag;
# exact enum values are not in the checkout — the bitmask layout below is
# our own, the MEMBERSHIP of each label matches the reference registry)
# ---------------------------------------------------------------------------
TAGLABEL_NOTAG = 0
TAGLABEL_TEXTFILE = 1
TAGLABEL_METADATA = 2
TAGLABEL_CTFPARAM = 4
TAGLABEL_IMAGE = 8
TAGLABEL_VOLUME = 16
TAGLABEL_STACK = 32
TAGLABEL_MICROGRAPH = 64
TAGLABEL_PSD = 128

_LABEL_TAGS = {
    "image": TAGLABEL_IMAGE | TAGLABEL_STACK,
    "image1": TAGLABEL_IMAGE,
    "image2": TAGLABEL_IMAGE,
    "imageOriginal": TAGLABEL_IMAGE | TAGLABEL_STACK,
    "imageRef": TAGLABEL_IMAGE,
    "imageResidual": TAGLABEL_IMAGE,
    "imageCovariance": TAGLABEL_IMAGE,
    "imageTilted": TAGLABEL_IMAGE,
    "micrograph": TAGLABEL_MICROGRAPH | TAGLABEL_IMAGE,
    "micrographOriginal": TAGLABEL_MICROGRAPH | TAGLABEL_IMAGE,
    "micrographTilted": TAGLABEL_MICROGRAPH | TAGLABEL_IMAGE,
    "psd": TAGLABEL_PSD | TAGLABEL_IMAGE,
    "psdEnhanced": TAGLABEL_PSD | TAGLABEL_IMAGE,
    "maskName": TAGLABEL_IMAGE,
    "ctfModel": TAGLABEL_CTFPARAM | TAGLABEL_METADATA,
    "selfile": TAGLABEL_METADATA,
    "vectorMetadata": TAGLABEL_METADATA,
}


def labelHasTag(label, tag) -> bool:
    return bool(_LABEL_TAGS.get(label2Str(label), 0) & int(tag))


def labelIsImage(label) -> bool:
    return labelHasTag(label, TAGLABEL_IMAGE)


_COLOR_NAMES = {0: "30", 1: "31", 2: "32", 3: "33", 4: "34", 5: "35",
                6: "36", 7: "37"}  # BLACK..WHITE (reference colorString)


def colorStr(color, s, attrib=1):
    """ANSI-colored string (reference colorString; attrib 1 = BRIGHT)."""
    return f"\x1b[{int(attrib)};{_COLOR_NAMES.get(int(color), '37')}m{s}\x1b[0m"


# ---------------------------------------------------------------------------
# MDQuery relational family (reference MDValueRelational + shortcuts)
# ---------------------------------------------------------------------------
class MDValueRelational(MDQuery):
    OP = "=="

    def __init__(self, label, value, op=None):
        self.label = label2Str(label)
        self.value = value
        if op is not None:
            self.OP = op
        super().__init__(f"{self.label} {self.OP} {value!r}")

    def mask(self, df):
        import operator as _op
        ops = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
               ">": _op.gt, ">=": _op.ge}
        return ops[self.OP](df[self.label], self.value)


class MDValueNE(MDValueRelational):
    OP = "!="


class MDValueLT(MDValueRelational):
    OP = "<"


class MDValueLE(MDValueRelational):
    OP = "<="


class MDValueGT(MDValueRelational):
    OP = ">"


class MDValueGE(MDValueRelational):
    OP = ">="


def addLabelAlias(label, alias, replace=False):
    from xmipp3_tpu_torch.core.labels import add_label_alias
    add_label_alias(label2Str(label), str(alias))


def getNewAlias(name):
    from xmipp3_tpu_torch.core.labels import get_new_alias
    return get_new_alias(str(name))


def activateRegExtensions():
    """SQL regexp() is always registered on our backend (core.metadata
    _register_extensions)."""
    return True


# ---------------------------------------------------------------------------
# File/metadata inspection helpers
# ---------------------------------------------------------------------------
def MetaDataInfo(value):
    """(xdim, ydim, zdim, ndim, size) of the first image of a metadata
    (reference xmipp_MetaDataInfo, xmippmodule.cpp:252-307; a filename
    argument parses only one row but reports the full row count)."""
    if isinstance(value, MetaData) or hasattr(value, "getColumnValues"):
        md, size = value, value.size()
    else:
        md = MetaData()
        md.setMaxRows(1)
        md.read(str(value))
        size = md.getParsedLines()
    first = md.getValue("image", 0) if md.containsLabel("image") else None
    if first is None:
        return 0, 0, 0, 0, size
    xdim, ydim, zdim, ndim = getImageSize(str(first))
    return xdim, ydim, zdim, ndim, size


def ImgCompare(fn1, fn2) -> bool:
    """Exact image equality (reference compareImage)."""
    a = _CoreImage(str(fn1)).data
    b = _CoreImage(str(fn2)).data
    return a.shape == b.shape and bool(_np.array_equal(a, b))


def checkImageFileSize(filename) -> bool:
    """True if the file on disk holds all the data its header promises
    (reference checkImageFileSize; used to detect half-written files).
    MRC checks header arithmetic; other formats attempt a full read."""
    fn = str(filename)
    path = _FileName(fn).path
    if not _os.path.exists(path):
        return False
    if path.lower().endswith((".mrc", ".mrcs", ".map", ".st")):
        try:
            with open(path, "rb") as f:
                hdr = f.read(1024)
            if len(hdr) < 1024:
                return False
            nx, ny, nz = _np.frombuffer(hdr[:12], "<i4")
            mode = int(_np.frombuffer(hdr[12:16], "<i4")[0])
            nsymbt = int(_np.frombuffer(hdr[92:96], "<i4")[0])
            sizes = {0: 1, 1: 2, 2: 4, 6: 2, 12: 2, 101: 0.5}
            need = 1024 + nsymbt + int(nx * ny * nz * sizes.get(mode, 4))
            return _os.path.getsize(path) >= need
        except Exception:
            return False
    try:
        _CoreImage(fn)
        return True
    except Exception:
        return False


def checkImageCorners(filename) -> bool:
    """Statistical sanity of the 4 corner patches vs the whole image: each
    corner's variance must be within a wide factor of the global variance
    (reference checkImageCorners flags acquisition artifacts; xmippCore
    impl not in the checkout — this is the documented equivalent test)."""
    d = _np.asarray(_CoreImage(str(filename)).data, _np.float64)
    if d.ndim != 2:
        d = d.reshape(d.shape[-2], d.shape[-1])
    h, w = d.shape
    ph, pw = max(h // 10, 2), max(w // 10, 2)
    g = d.std()
    if g == 0:
        return False
    for corner in (d[:ph, :pw], d[:ph, -pw:], d[-ph:, :pw], d[-ph:, -pw:]):
        ratio = corner.std() / g
        if not (0.01 < ratio < 100.0):
            return False
    return True


def dumpToFile(filename):
    """Dump the metadata backend to a SQLite file (reference
    MDSql::dumpToFile). Ours is columnar, so this is only meaningful per
    table: use MetaData.write('file.sqlite') — kept for API compatibility."""
    open(str(filename), "ab").close()


def readMetaDataWithTwoPossibleImages(filename, md):
    """Read a metadata whose rows may carry one or two image columns
    (reference metadata_extension readMetaDataWithTwoPossibleImages:
    plain selfiles with 2 tokens/row become image + image1)."""
    fn = str(filename)
    try:
        md.read(fn)
        if md.size():
            return
    except Exception:
        pass
    rows = []
    with open(fn) as fh:
        for line in fh:
            toks = line.split()
            if not toks or toks[0].startswith(("#", ";")):
                continue
            row = {"image": toks[0]}
            if len(toks) > 1:
                row["image1"] = toks[1]
            rows.append(row)
    if rows:
        md._df = _CoreMetaData.fromRows(rows)._df


def substituteOriginalImages(fn, fnOrig, fnOut, label, skipFirstBlock):
    """For every block of fn, replace each value of `label` (an n@stack
    slice) with the image of row n in fnOrig (reference
    substituteOriginalImages, metadata_extension; used by Scipion to map
    processed selfiles back to original micrograph particles)."""
    label = label2Str(label)
    orig = _CoreMetaData(str(fnOrig))
    orig_imgs = orig.getColumnValues("image")
    blocks = _CoreMetaData.blocksInFile(str(fn))
    first = True
    for i, b in enumerate(blocks):
        md = _CoreMetaData(f"{b}@{fn}")
        if not (skipFirstBlock and i == 0) and md.containsLabel(label):
            vals = []
            for v in md.getColumnValues(label):
                n = _FileName(str(v)).slice_index
                vals.append(orig_imgs[n - 1]
                            if n is not None and 1 <= n <= len(orig_imgs)
                            else v)
            md.setColumnValues(label, vals)
        md.write(f"{b}@{fnOut}", append=not first)
        first = False


# ---------------------------------------------------------------------------
# bsoft STAR block helpers (reference bsoftRemoveLoopBlock/RestoreLoopBlock;
# the reference's own gtests for these are disabled — semantics follow the
# disabled test_metadata_db_main.cpp:1710-1795: each input block splits
# into a row-format block (its key-value part, original name) plus
# loop_<k> blocks, and Restore re-merges them)
# ---------------------------------------------------------------------------
def bsoftRemoveLoopBlock(fnIn, fnOut):
    import re as _re
    text = open(str(fnIn)).read()
    out = ["# XMIPP_STAR_1 * ", "# "]
    loop_counter = 0
    blocks = _re.split(r"(?m)^data_", text)[1:]
    for blk in blocks:
        lines = blk.splitlines()
        name = lines[0].strip() or "noname"
        kv, loops, i = [], [], 1
        while i < len(lines):
            s = lines[i].strip()
            if s == "loop_":
                loop_counter += 1
                j = i + 1
                body = []
                while j < len(lines) and lines[j].strip() != "loop_" \
                        and not lines[j].strip().startswith("data_"):
                    body.append(lines[j])
                    j += 1
                loops.append((loop_counter, body))
                i = j
            else:
                if s and not s.startswith("#"):
                    kv.append(lines[i])
                i += 1
        out.append(f"data_{name}")
        out.extend(kv)
        out.append("")
        for k, body in loops:
            out.append(f"data_loop_{k}")
            out.append("loop_")
            out.extend(body)
            out.append("")
    with open(str(fnOut), "w") as f:
        f.write("\n".join(out) + "\n")


def bsoftRestoreLoopBlock(fnIn, fnOut):
    import re as _re
    text = open(str(fnIn)).read()
    blocks = _re.split(r"(?m)^data_", text)[1:]
    out = ["# XMIPP_STAR_1 * ", "# "]
    for blk in blocks:
        lines = blk.splitlines()
        name = lines[0].strip() or "noname"
        if name.startswith("loop_"):
            out.append("loop_")
            out.extend(lines[1:])
        else:
            out.append(f"data_{name}")
            out.extend(lines[1:])
    with open(str(fnOut), "w") as f:
        f.write("\n".join(out) + "\n")


# ---------------------------------------------------------------------------
# Geometry / CTF helpers
# ---------------------------------------------------------------------------
def alignWithZ(x, y, z, homogeneous=False):
    """Rotation matrix aligning (x,y,z) with Z (reference alignWithZ,
    xmippmodule.cpp:849-883; homogeneous -> 4x4)."""
    from xmipp3_tpu_torch.core.geometry import align_with_z
    R = _np.asarray(align_with_z(_np.array([x, y, z], _np.float64)))
    if not homogeneous:
        return R
    H = _np.eye(4)
    H[:3, :3] = R
    return H


def getPSF(inputCTF, Ts=0.5, rowId=0, device=None):
    """512-sample centered PSF profile from a CTF (reference xmipp_getPSF,
    xmippmodule.cpp:1290-1345: 256 damped-CTF samples at step 1/(2*Ts*256)
    evaluated on `device`, the card by default; unnormalized inverse FFT,
    CenterFFT on the host)."""
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    if isinstance(inputCTF, (str, FileName)):
        ctf = CTFDescription.from_metadata(str(inputCTF))
    else:
        md = inputCTF
        if int(rowId):
            sub = _CoreMetaData()
            sub.selectPart(md, int(rowId), 1)
            md = sub
        ctf = CTFDescription.from_metadata(md)
    ctf.sampling_rate = float(Ts)
    step = 1.0 / (2 * Ts * 256)
    f = _np.arange(256) * step
    prof = _host(ctf.pure_at(f, _np.zeros_like(f),
                             device=device)).astype(_np.float64)
    # FourierTransformer's backward transform is unnormalized (the forward
    # divides by N) -> irfft * N
    psf = _np.fft.irfft(prof.astype(_np.complex128), n=512) * 512
    return _np.fft.fftshift(psf)


def image_align(img1, img2, device=None):
    """Align img2 onto img1 considering mirrors on `device` (the card by
    default, as one CUDA graph there); returns the aligned image
    (reference Image_align -> alignImagesConsideringMirrors,
    xmippmodule.cpp:1195-1232)."""
    from xmipp3_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    ref = _np.asarray(img1.getData() if isinstance(img1, Image) else img1,
                      _np.float32)
    mov = _np.asarray(img2.getData() if isinstance(img2, Image) else img2,
                      _np.float32)[None]
    if dev.type == "cuda":
        aligned = _card_graph(_align_one, dev, ref.shape, mov.shape)(ref,
                                                                     mov)
    else:
        aligned = _align_one(_as_tensor(ref, dev), _as_tensor(mov, dev))
    out = Image()
    out.setData(_host(aligned)[0])
    return out


def applyCTF(image, ctfparam, Ts=1.0, rowId=0, absPhase=False, device=None):
    """Module-level twin of Image.applyCTF (reference Image_applyCTF)."""
    image.applyCTF(ctfparam, Ts, absPhase, device=device)


# ---------------------------------------------------------------------------
# Preview filters (reference xmippmodule.cpp:983-1103: read file, filter,
# LINEAR-scale to a dim-sized preview preserving aspect, store into the
# passed Image). The filters and the scaling run on `device`, the card by
# default; the preview comes back to the host.
# ---------------------------------------------------------------------------
def _preview_into(pyImage, data, dim, device=None):
    from xmipp3_tpu_torch.ops.resize import spline_resize_2d
    data = _as_tensor(data, device)
    h, w = data.shape[-2:]
    dim = int(dim)
    if dim > 0 and (h, w) != (dim, dim):
        if w >= h:
            out_w, out_h = dim, max(int(round(h * dim / w)), 1)
        else:
            out_h, out_w = dim, max(int(round(w * dim / h)), 1)
        data = spline_resize_2d(data[None], out_h, out_w, order=1)[0]
    pyImage.setData(_host(data))


def _read_on(fn, device, dtype=_torch.float32):
    return _as_tensor(_CoreImage(str(fn)).data, device, dtype)


def bandPassFilter(pyImage, fn, w1, w2, raised_w, dim, device=None):
    from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                     band_pass_mask)
    data = _read_on(fn, device)
    h, w = data.shape[-2:]
    out = apply_fourier_mask_2d(
        data, band_pass_mask(h, w, float(w1), float(w2), float(raised_w)))
    _preview_into(pyImage, out, dim)


def gaussianFilter(pyImage, fn, freqSigma, dim, device=None):
    """Fourier-domain gaussian low-pass, sigma in digital frequency."""
    from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                     gaussian_mask)
    data = _read_on(fn, device)
    h, w = data.shape[-2:]
    out = apply_fourier_mask_2d(data, gaussian_mask(h, w, float(freqSigma)))
    _preview_into(pyImage, out, dim)


def _reflect_index(n: int, r: int):
    """Indices of an axis of n samples padded by r on each side with
    half-sample symmetry (scipy.ndimage's "reflect": d c b a | a b c d)."""
    i = _np.arange(-r, n + r) % (2 * n)
    return _torch.as_tensor(_np.where(i >= n, 2 * n - 1 - i, i))


def _gaussian_filter(x, sigma: float):
    """Real-space gaussian convolution of every axis of x (scipy.ndimage
    gaussian_filter: kernel to 4 sigma, normalised to sum 1, reflected
    edges), as shifted sums on x's device."""
    r = int(4.0 * sigma + 0.5)
    t = _np.arange(-r, r + 1)
    k = _np.exp(-0.5 * t * t / sigma ** 2)
    k = (k / k.sum()).tolist()
    for ax in range(x.ndim):
        n = x.shape[ax]
        p = x.index_select(ax, _reflect_index(n, r).to(x.device))
        x = sum(k[j] * p.narrow(ax, j, n) for j in range(2 * r + 1))
    return x


def realGaussianFilter(pyImage, fn, realSigma, dim, device=None):
    """Real-space gaussian convolution, sigma in pixels."""
    data = _read_on(fn, device)
    _preview_into(pyImage, _gaussian_filter(data, float(realSigma)), dim)


def badPixelFilter(pyImage, fn, factor, dim, device=None):
    """Replace outlier pixels (|x - mean| > factor*std) with the local
    3x3 median (reference BadPixelFilter::OUTLIER)."""
    from xmipp3_tpu_torch.ops.spatial_filters import median_3x3
    data = _read_on(fn, device, _torch.float64)
    med = median_3x3(data)      # its edge replication is scipy's "reflect"
    bad = (data - data.mean()).abs() > float(factor) * data.std(
        correction=0)
    _preview_into(pyImage, _torch.where(bad, med, data).float(), dim)


def fastEstimateEnhancedPSD(pyImage, fn, downsampling, dim, Nthreads=1,
                            device=None):
    """Quick enhanced-PSD preview of a micrograph (reference
    fastEstimateEnhancedPSD, ctf_estimate_from_micrograph.cpp:924-:
    periodogram at an automatic piece size, then the enhance_psd
    bandpass + normalization, scaled to dim), on `device`, the card by
    default."""
    from xmipp3_tpu_torch.ops.psd import estimate_psd
    from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                     band_pass_mask)
    mic = _read_on(fn, device)
    if mic.ndim == 3:
        mic = mic[0]
    Y, X = mic.shape
    min_size = 2 * (max(X, Y) // 10)
    min_size = 1 << int(_np.ceil(_np.log2(max(min_size, 2))))
    min_size = int(min(1024, min_size, X, Y))
    min_size = int(min(min_size * float(downsampling), min(X, Y)))
    half = estimate_psd(mic, piece=min_size, overlap=0.5)
    hh, wh = half.shape
    wf = (wh - 1) * 2
    ys = (hh - _np.arange(hh)) % hh         # hermitian full spectrum
    xs = wf - _np.arange(wh, wf)
    mirror = half[_torch.as_tensor(ys, device=half.device)][
        :, _torch.as_tensor(xs, device=half.device)]
    p = _torch.log10(1.0 + _torch.cat([half, mirror], dim=1).abs())
    h, w = p.shape
    f = apply_fourier_mask_2d(p, band_pass_mask(h, w, 0.02, 0.2, 0.02))
    f = (f - f.mean()) / max(float(f.std(correction=0)), 1e-12)
    _preview_into(pyImage, _torch.fft.fftshift(f), dim)
