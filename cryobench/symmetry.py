"""Point groups from xmipp's symmetry names, as rotation matrices.

The benchmark's own, importing nothing of the program: a configuration
names its symmetry (`sizes.sym`) and every part of the benchmark that
needs the group (the map's blobs, the reference's symmetry copies and
asymmetric unit, the roofline's sample count) builds it here from
generators in xmipp's standard orientations:

  cN   an N-fold axis on z;
  dN   cN and a two-fold axis on x;
  t    a two-fold axis on z and a three-fold axis on (1, 1, 1);
  o    a four-fold axis on z and a three-fold axis on (1, 1, 1);
  i2   (also i) two-fold axes on x, y and z, a five-fold axis in the x-z
       plane at atan(1/golden ratio) from z; i1, i3 and i4 are i2 turned
       about y by 90, 31.7175 and -31.7175 degrees (xmipp's Euler matrix
       with that tilt alone).
"""
from __future__ import annotations

import math
import re

import numpy as np

GOLDEN = (1 + math.sqrt(5)) / 2
I_TILT = math.degrees(math.atan2(1.0, GOLDEN))      # 31.7175 degrees


def axis_rotation(axis, deg: float) -> np.ndarray:
    """The rotation by `deg` degrees about `axis` (Rodrigues), float64."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    t = math.radians(deg)
    return np.eye(3) + math.sin(t) * K + (1 - math.cos(t)) * (K @ K)


def close(generators) -> np.ndarray:
    """The group the generators span, identity first, (S, 3, 3)."""
    elems = [np.eye(3)]
    seen = {tuple(np.round(np.eye(3), 6).ravel())}
    i = 0
    while i < len(elems):
        for g in generators:
            m = g @ elems[i]
            k = tuple(np.round(m, 6).ravel() + 0.0)
            if k not in seen:
                seen.add(k)
                elems.append(m)
        i += 1
    return np.stack(elems)


def group(sym: str) -> np.ndarray:
    """The rotation group of symmetry `sym`, (S, 3, 3) float64."""
    s = sym.strip().lower()
    z = (0, 0, 1)
    m = re.fullmatch(r"([cd])(\d+)", s)
    if m and int(m.group(2)) >= 1:
        gens = [axis_rotation(z, 360.0 / int(m.group(2)))]
        if m.group(1) == "d":
            gens.append(axis_rotation((1, 0, 0), 180.0))
        return close(gens)
    if s == "t":
        return close([axis_rotation(z, 180.0),
                      axis_rotation((1, 1, 1), 120.0)])
    if s == "o":
        return close([axis_rotation(z, 90.0),
                      axis_rotation((1, 1, 1), 120.0)])
    m = re.fullmatch(r"i([1-4]?)", s)
    if m:
        five = (math.sin(math.radians(I_TILT)), 0.0,
                math.cos(math.radians(I_TILT)))
        g = close([axis_rotation(five, 72.0), axis_rotation(z, 180.0)])
        tilt = {"1": 90.0, "": 0.0, "2": 0.0, "3": I_TILT,
                "4": -I_TILT}[m.group(1)]
        # xmipp's Euler matrix of (0, tilt, 0) is the rotation by -tilt
        # about y
        R = axis_rotation((0, 1, 0), -tilt)
        return np.einsum("ij,sjk,lk->sil", R, g, R)
    raise ValueError(f"no rotation group for symmetry {sym!r}")
