"""Coordinate .pos metadata helpers (reference
py_xmipp/coordinatesTools/coordinatesTools.py API)."""
from __future__ import annotations

import os


def writeCoordsListToPosFname(mic_fname, list_x_y, outputRoot, micId=None):
    """Write picked (x, y) coordinates for a micrograph to
    <outputRoot>/<mic_basename>.pos (particles block)."""
    from xmipp3_tpu_torch.core.metadata import MetaData
    base = os.path.splitext(os.path.basename(str(mic_fname)))[0]
    fn = os.path.join(str(outputRoot), base + ".pos")
    rows = []
    for i, (x, y) in enumerate(list_x_y):
        row = {"xcoor": int(round(float(x))), "ycoor": int(round(float(y))),
               "itemId": i + 1}
        if micId is not None:
            row["micrographId"] = int(micId)
        rows.append(row)
    md = MetaData.fromRows(rows) if rows else MetaData()
    md.write(fn, block="particles")
    return fn


def readPosCoordsFromFName(fname, returnAlsoMicId=False):
    """Read (x, y) coordinate pairs back from a .pos metadata file."""
    from xmipp3_tpu_torch.core.metadata import MetaData
    md = MetaData(str(fname))
    coords = []
    mic_id = None
    for r in md.iterRows():
        coords.append((int(r.get("xcoor", r.get("X", 0))),
                       int(r.get("ycoor", r.get("Y", 0)))))
        if mic_id is None and "micrographId" in r:
            mic_id = int(r["micrographId"])
    if returnAlsoMicId:
        return coords, mic_id
    return coords
