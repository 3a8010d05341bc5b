"""EMX (Electron Microscopy eXchange) metadata import/export.

A copy of the reference package's core/emx.py (host: xml.etree and the
port's MetaData; the port imports nothing of that package).

Contract: the EMX 1.0 XML dialect of the reference fixtures
(resources/test/EMX/EMXread.emx, emx.xsd): <micrograph>/<particle> entities
keyed by (fileName, index), with flat scalar children (defocusU [nm],
acceleratingVoltage [kV], ...) and nested vector children (pixelSpacing/X,
boxSize/X, centerCoord/X, transformationMatrix/t11...).

Mapping to MDL labels follows the conventions of the reference's EMX
importer: defocus nm -> ctfDefocusU (Å), centerCoord -> xcoor/ycoor,
pixelSpacing -> sampling_rate.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from xmipp3_tpu_torch.core.metadata import MetaData

# EMX scalar field -> (MDL label, unit scale to our convention)
_SCALAR_MAP = {
    "acceleratingVoltage": ("ctfVoltage", 1.0),          # kV
    "defocusU": ("ctfDefocusU", 10.0),                   # nm -> Å
    "defocusV": ("ctfDefocusV", 10.0),
    "defocusUAngle": ("ctfDefocusAngle", 1.0),
    "amplitudeContrast": ("ctfQ0", 1.0),
    "cs": ("ctfSphericalAberration", 1.0),
    "fom": ("weight", 1.0),
    "activeFlag": ("enabled", 1.0),
}

_VECTOR_MAP = {
    ("pixelSpacing", "X"): ("sampling_rate", 1.0),
    ("boxSize", "X"): ("xSize", 1.0),
    ("boxSize", "Y"): ("ySize", 1.0),
    ("centerCoord", "X"): ("xcoor", 1.0),
    ("centerCoord", "Y"): ("ycoor", 1.0),
}


def read_emx(path: str) -> dict[str, MetaData]:
    """Parse an EMX file -> {'micrograph': MetaData, 'particle': MetaData}."""
    tree = ET.parse(path)
    root = tree.getroot()
    tables: dict[str, list[dict]] = {}
    for entity in root:
        if not isinstance(entity.tag, str) or entity.tag is ET.Comment:
            continue
        kind = entity.tag
        row = {"image": f"{entity.get('index', '1')}@{entity.get('fileName', '')}"
               if entity.get("index") else entity.get("fileName", "")}
        for child in entity:
            tag = child.tag
            if tag in _SCALAR_MAP and child.text and child.text.strip():
                label, scale = _SCALAR_MAP[tag]
                row[label] = float(child.text) * scale
            else:
                for sub in child:
                    key = (tag, sub.tag)
                    if key in _VECTOR_MAP and sub.text and sub.text.strip():
                        label, scale = _VECTOR_MAP[key]
                        row[label] = float(sub.text) * scale
                # transformation matrix t11..t34
                if tag == "transformationMatrix":
                    vals = {}
                    for sub in child:
                        if sub.text and sub.text.strip():
                            vals[sub.tag] = float(sub.text)
                    if vals:
                        row["transformMatrix"] = " ".join(
                            f"{k}={v:g}" for k, v in sorted(vals.items()))
        tables.setdefault(kind, []).append(row)
    return {k: MetaData.fromRows(v) for k, v in tables.items()}


def write_emx(path: str, md: MetaData, kind: str = "particle") -> None:
    """Export a MetaData table as EMX 1.0."""
    root = ET.Element("EMX", version="1.0")
    inv_scalar = {v[0]: (k, v[1]) for k, v in _SCALAR_MAP.items()}
    for i in md:
        r = md.getRow(i)
        image = str(r.get("image", f"{i + 1}@stack"))
        if "@" in image:
            idx, fn = image.split("@", 1)
            ent = ET.SubElement(root, kind, fileName=fn,
                                index=str(int(idx)))
        else:
            ent = ET.SubElement(root, kind, fileName=image)
        groups: dict[str, ET.Element] = {}
        for label, value in r.items():
            if label == "image" or isinstance(value, (str, np.ndarray)):
                continue
            if label in inv_scalar:
                tag, scale = inv_scalar[label]
                el = ET.SubElement(ent, tag)
                el.text = f"{float(value) / scale:g}"
        for (gtag, stag), (label, scale) in _VECTOR_MAP.items():
            if label in r and not isinstance(r[label], str):
                g = groups.get(gtag)
                if g is None:
                    g = ET.SubElement(ent, gtag)
                    groups[gtag] = g
                el = ET.SubElement(g, stag)
                el.text = f"{float(r[label]) / scale:g}"
    ET.indent(root)
    with open(path, "wb") as f:
        f.write(b"<?xml version='1.0' encoding='utf-8'?>\n")
        f.write(ET.tostring(root))
