"""Projection operator: Fourier central slices.

Counterpart of the Fourier part of the reference package's ops/project.py:
the padded volume is 3-D FFT'd once; each projection is a batched trilinear
gather of a rotated central slice from the complex cube, followed by a
batched irfft2 — thousands of projections become one gather and one batched
FFT. `project_real_space` is the ray-casting projector: the volume rotated
per view, trilinear, summed along z, in chunks of views.

Conventions: Euler ZYZ (core.geometry.euler_matrix); the projection of the
volume along direction A[2] has its 2D FFT equal to the central slice spanned
by rows A[0], A[1] of the volume FFT. Projections are (B, N, N) float32 for an
(N,N,N) volume.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.ops.fourier import shift_spec_2d


def prepare_fourier_volume(vol, pad_factor: float = 2.0, device=None):
    """Pad (centered), FFT, fftshift -> complex cube ready for slicing.

    Returns (vf, pad_n): vf is the centered full FFT of the padded volume,
    with fftshift applied on all axes and the phase convention arranged so
    that gathered slices invert directly to centered projections. A
    (B, N, N, N) stack gives (B, P, P, P) cubes."""
    vol = as_tensor(vol, device)
    N = vol.shape[-1]
    pad_n = int(round(N * pad_factor))
    pad_n += pad_n % 2
    p = pad_n - N
    lo = p // 2 + (p % 2)
    hi = p - lo
    volp = torch.nn.functional.pad(vol, (lo, hi, lo, hi, lo, hi))
    # center the volume origin at array origin for FFT phase: ifftshift
    dims = (-3, -2, -1)
    vf = torch.fft.fftshift(torch.fft.fftn(torch.fft.ifftshift(
        volp, dim=dims), dim=dims), dim=dims)
    return vf, pad_n


def extract_central_slices(vf, mats, out_n: int):
    """Gather rotated central slices from the centered FFT cube.

    vf: (P,P,P) complex64 centered FFT, or (B,P,P,P) cubes, one for each
    matrix; mats: (B,3,3) Euler matrices (rows = projection plane basis in
    volume coords); out_n: output image size (its frequency grid is scaled
    to the padded cube).

    Returns (B, out_n, out_n//2+1) complex64 rfft-layout slices."""
    P = vf.shape[-1]
    c = P // 2
    dev = vf.device
    mats = as_tensor(mats, dev)
    # The projection has sampling 1 px; its FFT sample f corresponds to
    # volume-frequency f (cycles/px), which sits at index f*P in the cube.
    kx = (torch.fft.rfftfreq(out_n, device=dev) * P)[None, None, :]
    ky = (torch.fft.fftfreq(out_n, device=dev) * P)[None, :, None]
    M = mats[:, :, :, None, None]
    # 3D frequency = kx * e_x + ky * e_y (rows 0,1 of M)
    zi = kx * M[:, 0, 2] + ky * M[:, 1, 2] + c
    yi = kx * M[:, 0, 1] + ky * M[:, 1, 1] + c
    xi = kx * M[:, 0, 0] + ky * M[:, 1, 0] + c
    z0, y0, x0 = (torch.floor(a).to(torch.int64) for a in (zi, yi, xi))
    fz, fy, fx = zi - z0, yi - y0, xi - x0
    flat = vf.reshape(-1)
    base = 0 if vf.dim() == 3 else (
        torch.arange(len(vf), device=dev) * P ** 3)[:, None, None]
    # the 8 corners in one gather (a few launches a call, not ~150),
    # summed in corner order as one at a time would be: corner k is
    # offset (k >> 2, k >> 1 & 1, k & 1) from (z0, y0, x0)
    k = torch.arange(8, device=dev).reshape(8, 1, 1, 1)
    dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
    w = (torch.where(dz == 1, fz, 1 - fz) * torch.where(dy == 1, fy, 1 - fy)
         * torch.where(dx == 1, fx, 1 - fx))
    zj, yj, xj = z0 + dz, y0 + dy, x0 + dx
    inside = ((zj >= 0) & (zj < P) & (yj >= 0) & (yj < P)
              & (xj >= 0) & (xj < P))
    idx = ((zj.clamp(0, P - 1) * P + yj.clamp(0, P - 1)) * P
           + xj.clamp(0, P - 1)) + base
    terms = torch.where(inside, w, 0.0) * flat[idx]
    out = terms[0]
    for j in range(1, 8):
        out = out + terms[j]
    return out


def slices_to_projections(slices, out_n: int):
    """Inverse-FFT rfft-layout central slices into centered projections.

    No extra scaling: by the discrete projection-slice theorem the gathered
    slice values ARE the projection's DFT (the padded volume was ifftshifted
    before fftn, so phases correspond to the centered origin)."""
    imgs = torch.fft.irfft2(slices, s=(out_n, out_n))
    return torch.fft.fftshift(imgs, dim=(-2, -1))


class FourierProjector:
    """Volume -> many projections via one 3D FFT + batched slice gathers
    (pad once, project many). The cube lives on `device` (default: the
    card)."""

    def __init__(self, vol, pad_factor: float = 2.0, device=None):
        self.device = resolve_device(device)
        with timed_phase("project.volume"):
            vol = as_tensor(vol, self.device)
            self.N = vol.shape[-1]
            self.vf, self.pad_n = prepare_fourier_volume(vol, pad_factor,
                                                         self.device)

    @classmethod
    def from_jax_state(cls, vf, N: int, pad_n: int, device=None):
        """A projector on a Fourier volume prepared by the reference
        package: vf is the numpy (pad_n,)*3 complex cube of its
        prepare_fourier_volume / FourierProjector.vf."""
        vf = np.array(vf, np.complex64)      # a writable copy
        if vf.shape != (pad_n,) * 3:
            raise ValueError(f"from_jax_state: vf has shape {vf.shape}, "
                             f"expected {(pad_n,) * 3}")
        proj = cls.__new__(cls)
        proj.device = resolve_device(device)
        proj.N, proj.pad_n = N, pad_n
        proj.vf = torch.as_tensor(vf, device=proj.device)
        return proj

    def project_euler(self, rot, tilt, psi, shifts=None):
        """Batched projection at Euler angles (degrees). Optional (B,2) shifts
        applied in Fourier space. Returns a (B, N, N) float32 tensor."""
        with timed_phase("project.slices"):
            rot = np.atleast_1d(np.asarray(rot, np.float32))
            tilt = np.atleast_1d(np.asarray(tilt, np.float32))
            psi = np.atleast_1d(np.asarray(psi, np.float32))
            mats = np.asarray(euler_matrix(rot, tilt, psi), np.float32)
            slices = extract_central_slices(self.vf, mats, self.N)
            if shifts is not None:
                shifts = as_tensor(shifts, self.device)
                slices = shift_spec_2d(slices, shifts[:, 0], shifts[:, 1],
                                       self.N, self.N)
            return slices_to_projections(slices, self.N)


def project_real_space(vol, rot, tilt, psi, order: int = 1, device=None,
                       chunk_bytes: int = 1 << 30):
    """Ray-casting projector: rotate the volume so the projection direction
    becomes z, then sum along z (reference projectVolume,
    data/projection.h:196). Returns a (B, N, N) float32 tensor on the
    volume's device (`device`; the card by default for a host volume).

    The rotated copy of view b is vol(A_b^T x) at every centred voxel x,
    trilinear with zeros outside (ops/geo.py::apply_affine_3d's warp),
    sampled for a chunk of views at once by grid_sample; a chunk's sample
    grid and rotated cubes hold about `chunk_bytes`. The views are
    independent, so the chunks give the numbers one batch would. `order`
    is the reference's (trilinear only)."""
    vol = as_tensor(vol, device)
    dev = vol.device
    D, H, W = vol.shape
    rot = np.atleast_1d(np.asarray(rot, np.float32))
    tilt = np.atleast_1d(np.asarray(tilt, np.float32))
    psi = np.atleast_1d(np.asarray(psi, np.float32))
    # the source of output voxel x is R x with R = A^-1 = A^T
    R = torch.as_tensor(np.asarray(euler_matrix(rot, tilt, psi), np.float32),
                        device=dev).transpose(1, 2)
    axes = [torch.arange(n, dtype=torch.float32, device=dev) - n // 2
            for n in (W, H, D)]                 # x, y, z
    shapes = ((1, 1, 1, -1), (1, 1, -1, 1), (1, -1, 1, 1))
    per = max(1, chunk_bytes // (16 * vol.numel()))
    out = []
    for s in range(0, len(R), per):
        Rc = R[s:s + per]
        grid = []
        for k, n in enumerate((W, H, D)):
            # source index along axis k, normalised as grid_sample takes it
            # (align_corners: -1 and 1 are the first and last voxels)
            src = sum(Rc[:, k, j].reshape(-1, 1, 1, 1) * axes[j].reshape(
                shapes[j]) for j in range(3)) + n // 2
            grid.append(src * (2.0 / (n - 1)) - 1.0)
        grid = torch.stack(grid, dim=-1)        # (b, D, H, W, 3)
        cubes = torch.nn.functional.grid_sample(
            vol.expand(len(Rc), 1, D, H, W), grid, mode="bilinear",
            padding_mode="zeros", align_corners=True)
        out.append(cubes[:, 0].sum(dim=1))
    return torch.cat(out)
