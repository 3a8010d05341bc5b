"""A cell's inputs, made on the card from the seed.

Everything here is the benchmark's own code and imports nothing of the
program. The recipes are copies of `chip_smoke.py`'s: `phantom` and
`projections` (Gaussian blobs and their exact line integrals; written
here as separable products, one batched matrix product a chunk of views,
so that 32,768 views of 360² take a fraction of a second), `plant_ctf`
(the CTF in float64, written apart from the program) and the noise
recipe of its phase 4. The phase flip is `ctf_phase_flip`'s rule: each
image's spectrum times the sign of its micrograph's CTF.

A micrograph group of `group` consecutive particles shares one CTF, with
defocusU drawn uniformly over the configuration's range, defocusV 300 Å
larger and the azimuth uniform over [0, 180). The same seed gives the same
map, poses, CTFs, noise and stack.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from cryobench.symmetry import group

CHUNK = 1024          # views a batched product makes at once


def euler_matrix(rot, tilt, psi):
    """xmipp's ZYZ Euler matrices (degrees) in float64, batched: rows 0 and
    1 span the projection plane, row 2 is the projection direction (a copy
    of Euler_angles2matrix)."""
    rot, tilt, psi = (np.deg2rad(np.asarray(a, np.float64))
                      for a in (rot, tilt, psi))
    c1, s1 = np.cos(rot), np.sin(rot)
    c2, s2 = np.cos(tilt), np.sin(tilt)
    c3, s3 = np.cos(psi), np.sin(psi)
    row0 = np.stack([c3 * c2 * c1 - s3 * s1, c3 * c2 * s1 + s3 * c1,
                     -c3 * s2], axis=-1)
    row1 = np.stack([-s3 * c2 * c1 - c3 * s1, -s3 * c2 * s1 + c3 * c1,
                     s3 * s2], axis=-1)
    row2 = np.stack([s2 * c1, s2 * s1, c2], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def blob_map(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """(K, 5) blobs (cx, cy, cz, sigma, amplitude) in pixels from the box
    centre: cfg's `blobs` per asymmetric unit, uniform in a ball of the
    particle's extent, replicated by the symmetry's operators."""
    b = cfg["map"]
    radius = 0.5 * b["extent_A"] / cfg["sizes"]["apix"]
    k = b["blobs_per_asymmetric_unit"]
    sig = rng.uniform(*b["blob_sigma_px"], k)
    r = (radius - 2 * sig) * rng.uniform(0, 1, k) ** (1 / 3)
    d = rng.standard_normal((k, 3))
    ctr = d / np.linalg.norm(d, axis=1, keepdims=True) * r[:, None]
    amp = rng.uniform(0.5, 1.5, k)
    out = [np.column_stack([ctr @ S.T, sig, amp])
           for S in group(cfg["sizes"]["sym"])]
    return np.concatenate(out)


def _axis(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float64, device=dev) - n // 2


def volume(blobs: np.ndarray, n: int, dev) -> torch.Tensor:
    """The map: the blobs sampled on the n³ grid (chip_smoke's `phantom`),
    float32 on `dev`."""
    c = _axis(n, dev)
    b = torch.as_tensor(blobs, device=dev)
    g = [torch.exp(-(c[None] - b[:, i, None]) ** 2
                   / (2 * b[:, 3, None] ** 2)) for i in range(3)]  # x, y, z
    zy = (g[2][:, :, None] * g[1][:, None, :]).reshape(len(b), -1)
    vol = zy.T @ (b[:, 4, None] * g[0])
    return vol.reshape(n, n, n).to(torch.float32)


def poses(rng: np.random.Generator, count: int, shift: float) -> dict:
    """Uniform directions, uniform psi and shifts uniform in ±`shift` px
    (chip_smoke's `cycle_poses`), float64 numpy."""
    rot = rng.uniform(0, 360, count)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, count)))
    psi = rng.uniform(0, 360, count)
    sx, sy = rng.uniform(-shift, shift, (2, count))
    return dict(rot=rot, tilt=tilt, psi=psi, sx=sx, sy=sy)


def projections(blobs: np.ndarray, n: int, p: dict, lo: int, hi: int,
                dev) -> torch.Tensor:
    """Exact projections of the blobs for views [lo, hi), each image's
    content moved by (-sx, -sy) so that the metadata shifts undo it
    (chip_smoke's `projections`): per view, the sum over blobs of
    a s sqrt(2 pi) gy(y) gx(x), one batched product; float32 (hi-lo, n, n)."""
    A = torch.as_tensor(euler_matrix(p["rot"][lo:hi], p["tilt"][lo:hi],
                                     p["psi"][lo:hi]), device=dev)
    b = torch.as_tensor(blobs, device=dev)
    shift = lambda k: torch.as_tensor(p[k][lo:hi], device=dev)[:, None]
    px = A[:, 0] @ b[:, :3].T - shift("sx")
    py = A[:, 1] @ b[:, :3].T - shift("sy")
    c = _axis(n, dev)
    s2 = 2 * b[:, 3] ** 2
    amp = b[:, 4] * b[:, 3] * math.sqrt(2 * math.pi)
    gy = torch.exp(-(c[None, :, None] - py[:, None, :]) ** 2 / s2) * amp
    gx = torch.exp(-(c[None, None, :] - px[:, :, None]) ** 2 / s2[:, None])
    return torch.bmm(gy, gx).to(torch.float32)


def ctf_values(fx, fy, dfu, dfv, az_deg, kv: float, cs_mm: float,
               q0: float):
    """The CTF at frequencies (fx, fy) in 1/Å, float64 torch, broadcast over
    the defocus arrays: chi = pi lambda df(theta) u^2 + pi/2 Cs lambda^3
    u^4 with df(theta) = -(dfU + dfV)/2 - (dfU - dfV)/2 cos 2(theta -
    azimuth); CTF = -(sqrt(1 - Q0^2) sin chi - Q0 cos chi)."""
    v = kv * 1e3
    lam = 12.2643247 / math.sqrt(v * (1 + 0.978466e-6 * v))
    u2 = fx * fx + fy * fy
    df = -(dfu + dfv) / 2 - (dfu - dfv) / 2 * torch.cos(
        2 * (torch.atan2(fy, fx) - torch.deg2rad(az_deg)))
    k2 = math.pi / 2 * cs_mm * 1e7 * lam ** 3
    chi = math.pi * lam * df * u2 + k2 * u2 * u2
    return -(math.sqrt(1 - q0 ** 2) * torch.sin(chi) - q0 * torch.cos(chi))


def plant_ctf(n: int, Ts: float, dfu, dfv, az, kv: float, cs: float,
              q0: float, dev) -> torch.Tensor:
    """The CTF of each micrograph in the rfft2 layout of an n x n image,
    float64 (G, n, n//2+1) (chip_smoke's `plant_ctf`): the self-conjugate
    columns (fx = 0 and Nyquist) are averaged over ±fy, so that the filter
    keeps real images real."""
    fy = torch.fft.fftfreq(n, dtype=torch.float64, device=dev)[:, None] / Ts
    fx = torch.fft.rfftfreq(n, dtype=torch.float64, device=dev)[None, :] / Ts
    col = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                    device=dev)[:, None, None]
    c = ctf_values(fx, fy, col(dfu), col(dfv), col(az), kv, cs, q0)
    for k in (0, -1):
        c[:, :, k] = 0.5 * (c[:, :, k] + torch.roll(c[:, :, k].flip(1), 1, 1))
    return c


@dataclass
class Data:
    """A cell's inputs: the map, the particle stack and the truth it was
    made from."""
    vol: torch.Tensor          # (n, n, n) float32
    stack: torch.Tensor        # (V, n, n) float32, phase flipped
    poses: dict                # rot, tilt, psi, sx, sy: (V,) float64
    groups: dict               # dfu, dfv, az: (G,) float64
    group_of: np.ndarray       # (V,) int64: each particle's micrograph


def make(cfg: dict, seed: int, dev) -> Data:
    """The map, the poses and the phase-flipped noisy stack of `cfg` from
    `seed`, on `dev`."""
    sz, ctf = cfg["sizes"], cfg["ctf"]
    n, V, G = sz["box"], cfg["particles"], ctf["group"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    blobs = blob_map(cfg, rng)
    p = poses(rng, V, cfg["shift_px"])
    ng = -(-V // G)
    dfu = rng.uniform(*ctf["defocus_A"], ng)
    groups = dict(dfu=dfu, dfv=dfu + ctf["astigmatism_A"],
                  az=rng.uniform(0, 180, ng))
    group_of = np.arange(V) // G
    plant = plant_ctf(n, sz["apix"], groups["dfu"], groups["dfv"],
                      groups["az"], sz["kv"], ctf["cs_mm"], ctf["q0"], dev)
    stack = torch.empty((V, n, n), dtype=torch.float32, device=dev)
    total = torch.zeros(2, dtype=torch.float64, device=dev)
    for lo in range(0, V, CHUNK):
        hi = min(lo + CHUNK, V)
        c = plant[torch.as_tensor(group_of[lo:hi], device=dev)]
        img = torch.fft.irfft2(torch.fft.rfft2(
            projections(blobs, n, p, lo, hi, dev).to(torch.float64)) * c,
            s=(n, n))
        total += torch.stack([img.sum(), (img * img).sum()])
        stack[lo:hi] = img.to(torch.float32)
    m = total[0] / (V * n * n)
    sigma = cfg["noise_sigma"] * torch.sqrt(total[1] / (V * n * n) - m * m)
    sign = torch.sign(plant)
    for lo in range(0, V, CHUNK):
        hi = min(lo + CHUNK, V)
        noisy = stack[lo:hi] + (sigma * torch.randn(
            (hi - lo, n, n), generator=gen, dtype=torch.float64,
            device=dev)).to(torch.float32)
        s = sign[torch.as_tensor(group_of[lo:hi], device=dev)]
        stack[lo:hi] = torch.fft.irfft2(
            torch.fft.rfft2(noisy.to(torch.float64)) * s,
            s=(n, n)).to(torch.float32)
    vol = volume(blobs, n, dev)
    return Data(vol=vol, stack=stack, poses=p, groups=groups,
                group_of=group_of)
