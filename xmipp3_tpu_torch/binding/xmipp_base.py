"""xmipp_base on the port: the reference's script toolkit.

The reference ships `bindings/python/xmipp_base.py` (XmippScript param-DSL
wrapper, CondaEnvManager conda-env dispatch, XmippMdRow, metadata pattern
helpers). Scripts written against it import this module unchanged.

CondaEnvManager is a stub: the reference spawns one pinned conda env per
DL tool (envs_DLTK/*.yml) because its tools mix TF/torch versions; here
every deep program runs on torch in this environment, so env resolution
returns the current environment and installation is a no-op.
"""
from __future__ import annotations

import glob as _glob
import os
import subprocess
import sys

from xmipp3_tpu_torch.binding.xmippLib import (FileName, Image, MetaData,
                                               Program, getImageSize,
                                               label2Str, str2Label)

CONDA_DEFAULT_ENVIRON = "base"


def xmippExists(path):
    return FileName(path).exists()


def getXmippPath(*paths):
    """Root of the installed package tree (reference: $XMIPP_HOME): the
    port's package directory unless XMIPP_HOME says otherwise."""
    root = os.environ.get("XMIPP_HOME", os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, *paths)


def getModel(*modelPath, doRaise=True, **kwargs):
    """Path under <root>/models/ (reference xmipp_base.getModel)."""
    path = getXmippPath("models", *modelPath)
    if doRaise and not os.path.exists(path):
        raise FileNotFoundError(f"Model not found: {path}")
    return path


class XmippScript:
    """Wrapper mirroring the reference XmippScript
    (bindings/python/xmipp_base.py:52-147)."""

    def __init__(self, runWithoutArgs=False):
        self._prog = Program(runWithoutArgs)

    # -- template methods ------------------------------------------------
    def defineParams(self):
        pass

    def readParams(self):
        pass

    def run(self):
        pass

    # -- param access ----------------------------------------------------
    def checkParam(self, param):
        return self._prog.checkParam(param)

    def getParam(self, param, index=0):
        return self._prog.getParam(param, index)

    def getIntParam(self, param, index=0):
        return int(self._prog.getParam(param, index))

    def getDoubleParam(self, param, index=0):
        return float(self._prog.getParam(param, index))

    def getListParam(self, param):
        return self._prog.getListParam(param)

    def addUsageLine(self, line, verbatim=False):
        self._prog.addUsageLine(line, verbatim)

    def addExampleLine(self, line, verbatim=True):
        self._prog.addExampleLine(line, verbatim)

    def addParamsLine(self, line):
        self._prog.addParamsLine(line)

    def tryRun(self):
        try:
            self.defineParams()
            doRun = self._prog.read(sys.argv)
            if doRun:
                self.readParams()
                self.run()
            return 0
        except Exception:
            import traceback
            traceback.print_exc(file=sys.stderr)
            return 1

    @staticmethod
    def getModel(*modelPath, **kwargs):
        return getModel(*modelPath, **kwargs)

    @classmethod
    def runCondaCmd(cls, program, arguments, **kwargs):
        """Run a tool directly in this environment (no conda env
        switching needed — see module docstring)."""
        kwargs.setdefault("env", CondaEnvManager.getCondaEnv(
            os.environ, CondaEnvManager.getCondaName(cls)))
        kwargs.pop("gpu", None)
        subprocess.check_call(f"{program} {arguments}", shell=True, **kwargs)


class CondaEnvManager:
    """Stub of the reference CondaEnvManager (xmipp_base.py:149): every
    method resolves to the CURRENT environment; install generators yield
    nothing (the deep programs run on torch in this environment)."""

    @staticmethod
    def getCondaName(xmippCls, **kwargs):
        return getattr(xmippCls, "_conda_env", CONDA_DEFAULT_ENVIRON)

    @staticmethod
    def getCondaExe(env=None):
        return sys.executable

    @staticmethod
    def getEnvironDir(condaEnv):
        return sys.prefix

    @staticmethod
    def getCondaEnv(environ, condaEnv):
        return dict(environ)

    @staticmethod
    def getCondaActivationCmd():
        return ""

    @staticmethod
    def yieldInstallAllCmds(useGpu):
        return iter(())

    @staticmethod
    def getCurInstalledDep(dependency, defaultVersion=None, environ=None):
        try:
            import importlib.metadata as im
            return im.version(dependency)
        except Exception:
            return defaultVersion

    @staticmethod
    def installEnvironCmd(name, requirementsFn, versionId=None, gpu=False):
        return ""


class XmippMdRow:
    """Dict-backed metadata row (reference xmipp_base.XmippMdRow:365)."""

    def __init__(self):
        self._values = {}
        self._objId = None

    def getObjId(self):
        return self._objId

    def hasLabel(self, label):
        return self.containsLabel(label)

    def containsLabel(self, label):
        return label2Str(label) in self._values

    def removeLabel(self, label):
        self._values.pop(label2Str(label), None)

    def setValue(self, label, value):
        self._values[label2Str(label)] = value

    def getValue(self, label, default=None):
        return self._values.get(label2Str(label), default)

    def readFromMd(self, md, objId):
        self._objId = objId
        row = md.getRow(objId)
        self._values = dict(row)

    def addToMd(self, md):
        self.writeToMd(md, md.addObject())

    def writeToMd(self, md, objId):
        for label, value in self._values.items():
            md.setValue(label, value, objId)

    def copyFromRow(self, other):
        self._values.update(other._values)

    def __str__(self):
        return " ".join(f"{k}={v}" for k, v in self._values.items())

    def __iter__(self):
        return iter(self._values)

    def printDict(self):
        print(str(self))


def createMetaDataFromPattern(pattern, isStack=False, label="image"):
    """Metadata from glob pattern(s); stacks expand to n@file rows
    (reference xmipp_base.createMetaDataFromPattern:461)."""
    pats = pattern if isinstance(pattern, list) else [pattern]
    files = sorted(f for p in pats for f in _glob.glob(p))
    md = MetaData()
    for f in files:
        faux = f + ":mrcs" if isStack and f.endswith(".mrc") else f
        n = getImageSize(faux)[3] if isStack else 1
        if n != 1:
            for j in range(n):
                oid = md.addObject()
                md.setValue(label, f"{j + 1:06d}@{faux}", oid)
                md.setValue("enabled", 1, oid)
        else:
            oid = md.addObject()
            md.setValue(label, faux, oid)
            md.setValue("enabled", 1, oid)
    return md


def getMdSize(filename):
    """Row count without a full parse (setMaxRows + getParsedLines)."""
    md = MetaData()
    md.setMaxRows(1)
    md.read(str(filename))
    return md.getParsedLines()


def isMdEmpty(filename):
    return getMdSize(filename) == 0


def readInfoField(fnDir, block, label, xmdFile="iterInfo.xmd"):
    md = MetaData(f"{block}@{os.path.join(fnDir, xmdFile)}")
    return md.getValue(label, 0)


def writeInfoField(fnDir, block, label, value, xmdFile="iterInfo.xmd"):
    md = MetaData()
    oid = md.addObject()
    md.setValue(label, value, oid)
    md.write(f"{block}@{os.path.join(fnDir, xmdFile)}", append=True)
