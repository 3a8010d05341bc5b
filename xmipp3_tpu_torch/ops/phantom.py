"""Analytic phantom engine (test-data generator).

Counterpart of the reference package's ops/phantom.py: the phantom
description language of data/phantom.h:40-120 ('#Phantom Xdim Ydim Zdim
Background [scale]' header + feature lines sph/blo/gau/cyl/dcy/cub/ell/con
with +/= behaviour) and its voxelization. The description is read and
written on the host; `voxelize` evaluates every feature on the voxel grid on
the card (float64 coordinates, float32 masks, as the reference evaluates
them), in the description's order, so that overlapping features add or
overwrite the same way. Oriented features use the ZYZ Euler convention of
core.geometry.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.device import resolve_device


def _orientation(p, start: int):
    """The (rot, tilt, psi) a feature's parameters carry from `start` on
    (zeros when absent)."""
    return tuple((p[start:start + 3] + [0, 0, 0])[:3]) if len(p) > start \
        else (0, 0, 0)


@dataclass
class Feature:
    ftype: str
    add_assign: str
    density: float
    center: np.ndarray
    params: list[float] = field(default_factory=list)

    def _local_coords(self, X, Y, Z, rot=0.0, tilt=0.0, psi=0.0):
        """Coordinates relative to center, rotated into the feature frame."""
        x = X - float(self.center[0])
        y = Y - float(self.center[1])
        z = Z - float(self.center[2])
        if rot or tilt or psi:
            A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)
            xl = A[0, 0] * x + A[0, 1] * y + A[0, 2] * z
            yl = A[1, 0] * x + A[1, 1] * y + A[1, 2] * z
            zl = A[2, 0] * x + A[2, 1] * y + A[2, 2] * z
            return xl, yl, zl
        return x, y, z

    def evaluate(self, X, Y, Z) -> torch.Tensor:
        """The feature's float32 mask (or profile) on the grid X, Y, Z
        (float64 tensors, broadcastable)."""
        t, p = self.ftype, self.params
        f32 = torch.float32
        if t == "sph":
            x, y, z = self._local_coords(X, Y, Z)
            return (x * x + y * y + z * z <= p[0] ** 2).to(f32)
        if t == "gau":
            x, y, z = self._local_coords(X, Y, Z)
            s2 = p[0] ** 2
            return torch.exp(-(x * x + y * y + z * z) / (2 * s2)).to(f32)
        if t == "blo":
            # Kaiser-Bessel blob (radius, alpha, order m): the radius on the
            # card, the Bessel profile of the voxels inside on the host
            from scipy.special import iv
            x, y, z = self._local_coords(X, Y, Z)
            r = torch.sqrt(x * x + y * y + z * z)
            a, alpha, m = p[0], p[1], int(p[2]) if len(p) > 2 else 2
            w = torch.zeros_like(r)
            inside = r <= a
            ri = r[inside].cpu().numpy()
            q = np.sqrt(np.clip(1 - (ri / a) ** 2, 0, 1))
            w[inside] = torch.as_tensor(
                (q ** m) * iv(m, alpha * q) / max(iv(m, alpha), 1e-12),
                device=r.device)
            return w.to(f32)
        if t == "cyl":
            rx, ry, h = p[0], p[1], p[2]
            x, y, z = self._local_coords(X, Y, Z, *_orientation(p, 3))
            return (((x / rx) ** 2 + (y / ry) ** 2 <= 1)
                    & (torch.abs(z) <= h / 2)).to(f32)
        if t == "dcy":
            r0, h, sep = p[0], p[1], p[2]
            x, y, z = self._local_coords(X, Y, Z, *_orientation(p, 3))
            inxy = x * x + y * y <= r0 ** 2
            up = torch.abs(z - (sep / 2 + h / 2)) <= h / 2
            dn = torch.abs(z + (sep / 2 + h / 2)) <= h / 2
            return (inxy & (up | dn)).to(f32)
        if t == "cub":
            dx, dy, dz = p[0], p[1], p[2]
            x, y, z = self._local_coords(X, Y, Z, *_orientation(p, 3))
            return ((torch.abs(x) <= dx / 2) & (torch.abs(y) <= dy / 2)
                    & (torch.abs(z) <= dz / 2)).to(f32)
        if t == "ell":
            rx, ry, rz = p[0], p[1], p[2]
            x, y, z = self._local_coords(X, Y, Z, *_orientation(p, 3))
            return (((x / rx) ** 2 + (y / ry) ** 2 + (z / rz) ** 2) <= 1
                    ).to(f32)
        if t == "con":
            r0, h = p[0], p[1]
            x, y, z = self._local_coords(X, Y, Z, *_orientation(p, 2))
            # apex up: radius shrinks linearly from base (z=-h/2) to 0 (z=h/2)
            frac = torch.clamp((h / 2 - z) / h, 0, 1)
            return ((x * x + y * y <= (r0 * frac) ** 2)
                    & (torch.abs(z) <= h / 2)).to(f32)
        raise ValueError(f"unknown feature type {t}")


@dataclass
class Phantom:
    dims: tuple = (64, 64, 64)
    background: float = 0.0
    scale: float = 1.0
    features: list = field(default_factory=list)

    @classmethod
    def read(cls, path: str) -> "Phantom":
        from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
        ph = cls()
        with open(path) as f:
            lines = [l.strip() for l in f
                     if l.strip() and not l.strip().startswith("#")]
        if not lines:
            raise XmippError(ErrCode.IO_SIZE, f"empty phantom file {path}")
        try:
            hdr = lines[0].split()
            ph.dims = (int(hdr[0]), int(hdr[1]), int(hdr[2]))
            ph.background = float(hdr[3])
            ph.scale = float(hdr[4]) if len(hdr) > 4 else 1.0
            for line in lines[1:]:
                toks = line.split()
                ph.features.append(Feature(
                    toks[0], toks[1], float(toks[2]),
                    np.array([float(toks[3]), float(toks[4]), float(toks[5])]),
                    [float(t) for t in toks[6:]]))
        except (ValueError, IndexError) as e:
            raise XmippError(ErrCode.PARAM_INCORRECT,
                             f"bad phantom description {path}: {e}") from e
        return ph

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("# Phantom description file, (generated with phantom "
                    "help)\n")
            f.write("# General Volume Parameters:\n")
            f.write("#      Xdim      Ydim      Zdim   Background_Density "
                    "Scale\n")
            x, y, z = self.dims
            f.write(f"       {x} {y} {z} {self.background} {self.scale}\n")
            f.write("# Feature Parameters:\n")
            for ft in self.features:
                pstr = " ".join(f"{v:g}" for v in ft.params)
                f.write(f"{ft.ftype} {ft.add_assign} {ft.density:g} "
                        f"{ft.center[0]:g} {ft.center[1]:g} "
                        f"{ft.center[2]:g} {pstr}\n")

    def voxelize(self, device=None) -> torch.Tensor:
        """The (Z, Y, X) float32 volume, on `device` (the card by
        default)."""
        dev = resolve_device(device)
        nx, ny, nz = self.dims
        f64 = torch.float64
        # R3 coords: x in [-nx//2, ...], array indexed [z, y, x]
        z = (torch.arange(nz, dtype=f64, device=dev) - nz // 2)[:, None, None]
        y = (torch.arange(ny, dtype=f64, device=dev) - ny // 2)[None, :, None]
        x = (torch.arange(nx, dtype=f64, device=dev) - nx // 2)[None, None, :]
        if self.scale != 1.0:
            x, y, z = x / self.scale, y / self.scale, z / self.scale
        shape = (nz, ny, nx)
        X, Y, Z = (a.expand(shape) for a in (x, y, z))
        vol = torch.full(shape, self.background, dtype=torch.float32,
                         device=dev)
        for ft in self.features:
            m = ft.evaluate(X, Y, Z)
            if ft.add_assign == "+":
                vol += ft.density * m
            else:
                vol = torch.where(m > 0, ft.density * m, vol)
        return vol
