"""Probe why tomo_detect_missing_wedge and image_peak_high_contrast miss
the wedge and the beads of phase 16's reconstruction (ROADMAP.md section
3, items 26-27), on the card's tomogram as tools/phase_alone.py 16 --keep
rec_truth.mrc saves it:

- the wedge: the spectrum's mean dB, within the fit's ball (|f| <= 0.25,
  fx > 0), by the angle about y from the x axis, and the mean dB of the
  probe slab at fx = 1/W, which is what a plane normal to x scores when
  the other side of its probe holds no sample;
- the beads: the program's stages written out in numpy (the slice-wise
  band-pass, the dark threshold from the central slices, the connected
  components, the mirror filter, the Mahalanobis distances of the radial
  profiles): the component nearest each planted bead, and the
  Mahalanobis distances of the beads' components and of the others.

Run from the repo root on the CPU (about a minute, 6 GB):

    python tools/probe_tomo_faults.py chiprun_out/p16_rec_truth.npz
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from plan_tomo import load_kept  # noqa: E402


def wedge_spectrum(vol) -> dict:
    D, H, W = vol.shape
    db = 20 * np.log10(np.maximum(np.abs(np.fft.fftn(vol)), 1e-12))
    fz, fy, fx = np.meshgrid(np.fft.fftfreq(D), np.fft.fftfreq(H),
                             np.fft.fftfreq(W), indexing="ij")
    r2 = fz ** 2 + fy ** 2 + fx ** 2
    ball = (r2 <= 0.25 ** 2) & (r2 > 0) & (fx > 1e-9)
    ang = np.degrees(np.arctan2(fz, fx))
    edges = (-90, -70, -62, -58, -50, 0, 50, 58, 62, 70, 90)
    return {"mean_db_by_angle": {
        f"[{a},{b})": float(db[ball & (ang >= a) & (ang < b)].mean())
        for a, b in zip(edges[:-1], edges[1:])},
        "slab_fx_1_over_W_db": float(db[ball & np.isclose(fx, 1 / W)].mean())}


def bead_stages(vol, fiducials, fid_px: int, box: int) -> dict:
    from scipy import ndimage
    from scipy.spatial import cKDTree

    from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                     band_pass_mask)
    Z, H, W = vol.shape
    filt = apply_fourier_mask_2d(
        vol, band_pass_mask(H, W, 1 / (4 * fid_px), min(2 / fid_px, 0.45)),
        device="cpu").numpy()
    samp = filt[Z // 2 - 5:Z // 2 + 5]
    dark = filt < samp.mean() - 5 * samp.std()
    labels, n = ndimage.label(dark)
    ids = np.arange(1, n + 1)
    size = ndimage.sum_labels(dark, labels, ids)
    cent = np.array(ndimage.center_of_mass(dark, labels, ids))[:, ::-1]
    cent, size = cent[size >= 10], size[size >= 10]
    dist, near = cKDTree(cent).query(fiducials)
    h = box // 2
    xyz = np.rint(cent).astype(int)
    inside = ((xyz[:, 0] >= h) & (xyz[:, 0] < W - h) & (xyz[:, 1] >= h)
              & (xyz[:, 1] < H - h))
    xyz = xyz[inside]
    bx = np.stack([filt[z, y - h:y + h, x - h:x + h] for x, y, z in xyz])
    b = bx - bx.mean(axis=(1, 2), keepdims=True)
    m = b[:, ::-1, ::-1]
    cc = (b * m).sum(axis=(1, 2)) / np.sqrt((b * b).sum(axis=(1, 2))
                                            * (m * m).sum(axis=(1, 2)))
    xyz, bx = xyz[cc >= 0.1], bx[cc >= 0.1]
    yy, xx = np.mgrid[0:box, 0:box] - h
    r = np.sqrt(yy * yy + xx * xx).astype(int)
    prof = np.stack([[q[r == k].mean() for k in range(h)] for q in bx])
    icov = np.linalg.inv(np.cov(prof.T) + 1e-6 * np.eye(h))
    d = prof - prof.mean(axis=0)
    maha = np.sqrt(np.einsum("ni,ij,nj->n", d, icov, d))
    bead = cKDTree(fiducials).query(xyz)[0] <= fid_px
    return {"components": int(n), "at_least_10_voxels": len(size),
            "nearest_to_each_bead_px": np.round(dist, 2).tolist(),
            "their_voxels": size[near].astype(int).tolist(),
            "largest_12_are_beads": bool(set(np.argsort(-size)[:12])
                                         == set(near)),
            "after_mirror": len(xyz),
            "mahalanobis_of_beads": np.round(maha[bead], 3).tolist(),
            "mahalanobis_of_others_median": float(np.median(maha[~bead])),
            "others_within_2": int((maha[~bead] <= 2).sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tomogram")
    args = ap.parse_args()
    vol = load_kept(args.tomogram)
    thickness, size = vol.shape[0], vol.shape[1]
    fid_px = max(int(round(cs.TM_FID_A / cs.TM_TS)), 3)
    *_, fid = cs.tomo_geometry(0, size, thickness, cs.TM_BOX,
                               cs.TM_PARTICLES, cs.TM_FIDUCIALS, fid_px)
    fid = (fid + [size // 2, size // 2, thickness // 2]).astype(np.float64)
    print(json.dumps({"wedge": wedge_spectrum(vol), "beads": bead_stages(
        vol, fid, fid_px, 4 * fid_px)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
