"""MDL_* metadata label registry (STAR column names + types).

Contract: the reference keys every metadata table by MDLabel enums whose STAR
string decorations appear in .xmd files as ``_<name>`` (e.g. ``_image``,
``_angleRot``, ``_ctfDefocusU``; see the reference's
resources/test/sampling/ref_sampling.xmd and libraries/py_xmipp/swiftalign/metadata/labels.py).
The enum itself lives in xmippCore (absent from the checkout), so this registry
is rebuilt from the label strings observed in fixtures + the swiftalign label
table + the standard Xmipp/Scipion naming convention MDL_FOO_BAR -> fooBar.

Unknown labels encountered while parsing are accepted verbatim with inferred
types (matching the reference's tolerance of "noXmipp" files,
resources/test/metadata/noXmipp.xmd).
"""
from __future__ import annotations

import enum


class LabelType(enum.Enum):
    INT = "int"
    LONG = "long"          # size_t labels (itemId, gatherId, ...)
    DOUBLE = "double"
    STRING = "string"
    BOOL = "bool"
    VECTOR = "vectorDouble"


_I, _L, _D, _S, _B, _V = (LabelType.INT, LabelType.LONG, LabelType.DOUBLE,
                          LabelType.STRING, LabelType.BOOL, LabelType.VECTOR)

# name -> type; written to STAR as "_" + name.
LABELS: dict[str, LabelType] = {
    # identity / bookkeeping
    "image": _S, "image1": _S, "image2": _S, "imageRef": _S,
    "imageOriginal": _S, "imageResidual": _S, "imageIdx": _L,
    "micrograph": _S, "micrographOriginal": _S, "micrographId": _L,
    "micrographMovie": _S, "itemId": _L, "gatherId": _L, "objId": _L,
    "enabled": _I, "ref": _I, "ref2": _I, "ref3d": _I, "order_": _L,
    "frameId": _L, "particleId": _L,
    # geometry / alignment
    "angleRot": _D, "angleRot2": _D, "angleTilt": _D, "angleTilt2": _D,
    "anglePsi": _D, "anglePsi2": _D, "angleY": _D, "angleY2": _D,
    "angleDiff": _D, "angleDiff0": _D, "angleDiff2": _D,
    "anglePsiDiff": _D, "angleRotDiff": _D,
    "angleTiltDiff": _D,
    "weightJumper": _D, "weightJumper0": _D, "weightJumper2": _D,
    "shiftX": _D, "shiftX2": _D, "shiftX3": _D,
    "shiftY": _D, "shiftY2": _D, "shiftY3": _D,
    "shiftZ": _D, "shiftZ2": _D, "shiftDiff": _D, "shiftDiff0": _D,
    "shiftDiff2": _D,
    "flip": _B, "scale": _D, "scale2": _D, "scale3": _D,
    "xcoor": _I, "ycoor": _I, "zcoor": _I,
    "x": _D, "y": _D, "z": _D, "X": _D, "Y": _D, "Z": _D,
    "transformMatrix": _S,
    # scores / weights
    "cost": _D, "maxCC": _D, "weight": _D, "weightContinuous2": _D,
    "weightSignificant": _D, "weightAlignabilityPrecision": _D,
    "weightAlignabilityAccuracy": _D,
    "zScore": _D, "zScoreShape1": _D, "zScoreShape2": _D,
    "zScoreSNR1": _D, "zScoreSNR2": _D, "zScoreHistogram": _D,
    "pMax": _D, "logLikelihood": _D, "mirrorFraction": _D,
    "scoreByPcaResidual": _D, "correlationIdx": _D, "correlationWeight": _D,
    # classes / counts
    "class": _I, "classCount": _L, "classificationData": _V,
    "classificationDataSize": _L, "count": _L, "count2": _L,
    "defGroup": _I, "dimred": _V,
    # sampling / neighbors
    "sampling_rate": _D, "samplingRateX": _D, "samplingRateY": _D,
    "samplingRateZ": _D, "neighbor": _L, "neighbors": _V,
    "neighborhoodRadius": _D, "pointsAsymmetricUnit": _L, "symmetry": _S,
    # resolution / FSC
    "resolutionFreq": _D, "resolutionFreq2": _D, "resolutionFreqReal": _D,
    "resolutionFreqMin": _D, "resolutionFreqMax": _D, "resolutionLocal": _D,
    "resolutionFRC": _D,
    "resolutionFRCRandomNoise": _D, "resolutionDPR": _D, "resolutionSSNR": _D,
    "resolutionLocalResidue": _D, "cumulativeSSNR": _D,
    "resolutionErrorL2": _D, "resolutionRfactor": _D,
    "logStructureFactor": _D, "structureFactor": _D,
    # projection subtraction (subtract_projection.cpp writeParticle)
    "subtractionR2": _D, "subtractionBeta0": _D, "subtractionBeta1": _D,
    "subtractionB": _D,
    # CTF forward model (.ctfparam contract, data/ctf.h:782)
    "ctfModel": _S, "ctfSamplingRate": _D, "ctfVoltage": _D,
    "ctfDefocusU": _D, "ctfDefocusV": _D, "ctfDefocusAngle": _D,
    "ctfDefocusA": _D, "ctfDefocusChange": _D,
    "ctfSphericalAberration": _D, "ctfChromaticAberration": _D,
    "ctfEnergyLoss": _D, "ctfLensStability": _D, "ctfConvergenceCone": _D,
    "ctfLongitudinalDisplacement": _D, "ctfTransversalDisplacement": _D,
    "ctfQ0": _D, "ctfK": _D, "ctfEnvR0": _D, "ctfEnvR1": _D, "ctfEnvR2": _D,
    "ctfBgGaussianK": _D, "ctfBgGaussianSigmaU": _D, "ctfBgGaussianSigmaV": _D,
    "ctfBgGaussianCU": _D, "ctfBgGaussianCV": _D, "ctfBgGaussianAngle": _D,
    "ctfBgSqrtK": _D, "ctfBgSqrtU": _D, "ctfBgSqrtV": _D,
    "ctfBgSqrtAngle": _D, "ctfBgBaseline": _D,
    "ctfBgGaussian2K": _D, "ctfBgGaussian2SigmaU": _D,
    "ctfBgGaussian2SigmaV": _D, "ctfBgGaussian2CU": _D,
    "ctfBgGaussian2CV": _D, "ctfBgGaussian2Angle": _D,
    "ctfX0": _D, "ctfXF": _D, "ctfY0": _D, "ctfYF": _D,
    "ctfCritFitting": _D, "ctfCritCorr13": _D, "ctfCritMaxFreq": _D,
    "ctfCritPsdInt": _D,
    "ctfCritDamping": _D, "ctfCritPsdRadialIntegral": _D,
    "ctfCritFirstZero": _D, "ctfCritFirstZeroRatio": _D,
    "ctfCritFirstZeroDisagreement": _D, "ctfCritNormality": _D,
    "ctfCritPsdStdQ": _D, "ctfCritPsdPCA1": _D, "ctfCritPsdPCARuns": _D,
    "ctfCritIceness": _D, "ctfVPPphaseshift": _D, "ctfVPPRadius": _D,
    "ctfPhaseFlipped": _B, "ctfCorrected": _B,
    # continuous assignment
    "continuousX": _D, "continuousY": _D, "continuousFlip": _B,
    "continuousGrayA": _D, "continuousGrayB": _D,
    "continuousScaleX": _D, "continuousScaleY": _D, "continuousScaleAngle": _D,
    # deformation / flexibility
    "sphCoefficients": _V, "sphDeformation": _D, "nmaModefile": _S,
    "nmaDisplacements": _V, "nmaEnergy": _D, "nmaMinRange": _D,
    "nmaMaxRange": _D,
    # image stats / misc
    "min": _D, "max": _D, "avg": _D, "stddev": _D, "sum": _D,
    "intScale": _D, "xSize": _I, "ySize": _I, "zSize": _I, "nSize": _L,
    "psd": _S, "psdEnhanced": _S, "noiseModel": _S, "noiseParticle": _S,
    "movieFrameShiftX": _V, "movieFrameShiftY": _V, "movieAlignment": _S,
    "dose": _D, "preDose": _D, "opticsGroup": _I, "opticsGroupName": _S,
    "phantomFeatureType": _S, "phantomFeatureSpecific": _V,
    "phantomFeatureCenter": _V, "phantomFeatureDensity": _D,
    "phantomBGDensity": _D, "phantomScale": _D,
    "maskFile": _S, "missingWedge": _I, "magnification": _D,
    "tiltAngle": _D, "tiltAxisAngle": _D, "tsId": _S, "tomoName": _S,
    "subtomoName": _S, "coordinateIdx": _L, "halfMap1": _S, "halfMap2": _S,
    "bFactor": _D, "iterationNumber": _I, "sigmaNoise": _D,
    "sigmaOffset": _D, "signalChange": _D, "wRobust": _D,
    "maxShift": _D, "maxShiftChange": _D, "rotationalSpectrum": _V,
    "selfile": _S, "vectorMetadata": _S, "crystalLatticeA": _V,
    "crystalLatticeB": _V, "crystalShiftX": _D, "crystalShiftY": _D,
}

# Commonly used aliases of old/foreign spellings seen in legacy files.
ALIASES: dict[str, str] = {
    "CTFModel": "ctfModel",
    "CTF_Defocus_U": "ctfDefocusU",
    "CTF_Defocus_V": "ctfDefocusV",
    "CTF_Defocus_angle": "ctfDefocusAngle",
    "defocusU": "ctfDefocusU",
    "defocusV": "ctfDefocusV",
    "original_image": "imageOriginal",
}


def label_type(name: str) -> LabelType:
    """Type of a label; unknown labels default to STRING (caller may re-infer)."""
    name = ALIASES.get(name, name)
    return LABELS.get(name, LabelType.STRING)


def is_known(name: str) -> bool:
    return name in LABELS or name in ALIASES


def add_label_alias(canonical: str, alias: str) -> None:
    """Register a foreign spelling for an existing label so files using it
    read into the canonical column (reference MDL::addLabelAlias,
    test_metadata_vec_main.cpp addLabelAlias)."""
    ALIASES[alias] = canonical


def get_new_alias(name: str) -> str:
    """Register an unknown label under a buffer slot and return its column
    name (reference MDL::getNewAlias -> BUFFER_xx whose label2Str is the
    original spelling; our columnar store keeps the spelling itself)."""
    ALIASES.setdefault(name, name)
    return name
