"""xmipp_image_align_tilt_pairs (centilt) of the reference package's
programs/align_tilt_pairs.py: center the tilted images of tilted-untilted
pairs against the untilted class average with cosine-stretch correction
(reference reconstruction/align_tilt_pairs.{h,cpp}: ProgAlignTiltPairs
:42-77, centerTiltedImage :66-149, run loop :153-260). Distinct from
image_assignment_tilt_pair, which pairs the coordinates.

Every pair's stretch warp and its shift against the reference run in one
batch on the card unless `--device cpu` is given; the 3x3 and 4x4
geometry of each row stays on the host in float64, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core import euler_orders as eo
from xmipp3_tpu_torch.core.image import Image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device


def _euler4(rot, tilt, psi):
    """Euler_angles2matrix(rot, tilt, psi, E, homogeneous=true) in f64."""
    return np.asarray(eo.to_matrix(np.deg2rad(psi), np.deg2rad(tilt),
                                   np.deg2rad(rot), eo.ZYZ), np.float64)


def stretch_matrix(flip, in_plane_u, shift_xu, shift_yu, alpha_t, alpha_u,
                   tilt, do_stretch=True):
    """The reference centerTiltedImage's A2D = Mu2D · E2D^-1, which maps
    the tilted image into the untilted frame (float64, 3 x 3)."""
    t = tilt if do_stretch else (180.0 if flip else 0.0)
    E = _euler4(alpha_u if flip else -alpha_u, t, alpha_t)
    a = np.deg2rad(in_plane_u)
    c, s = np.cos(a), np.sin(a)
    Mu2D = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    Mu2D[0, 2] = shift_xu if flip else -shift_xu
    Mu2D[1, 2] = -shift_yu
    if flip:
        Mu2D[1, 0] *= -1
        Mu2D[2, 0] *= -1
        Mu2D[0, 1] *= -1
        Mu2D[0, 2] *= -1
    E2D = np.eye(3)
    E2D[:2, :2] = E[:2, :2]
    return Mu2D @ np.linalg.inv(E2D)


def center_tilted_images(img_ref, imgs_t, A2D, max_shift_pct, device=None):
    """The reference centerTiltedImage for a batch: warp each tilted image
    by its A2D (bilinear, wrapped), find its best shift against the
    untilted reference, and map the shift back through the stretch
    (Tt = A^-1 · T · A). Returns (shift_x, shift_y, enable) numpy arrays.

    The shift keeps the direct sense (`shift(img, s)` registers the
    image), where the reference C++ composes with T^-1 for consumers that
    apply stored shifts the other way; the conjugation through A2D is
    the same (align_tilt_pairs.cpp:127-133)."""
    from xmipp3_tpu_torch.ops.geo import apply_affine_2d
    from xmipp3_tpu_torch.ops.shift import best_shift
    dev = resolve_device(device)
    warped = apply_affine_2d(torch.as_tensor(imgs_t, device=dev),
                             torch.as_tensor(A2D, dtype=torch.float32,
                                             device=dev), order=1, wrap=True)
    max_shift_pixels = int(max_shift_pct / 100.0 * imgs_t.shape[-1])
    dx, dy, corr = (a.cpu().numpy().astype(np.float64) for a in best_shift(
        torch.as_tensor(img_ref, device=dev), warped,
        max_shift=max(max_shift_pixels, 1)))
    Tt2D = np.tile(np.eye(3), (len(dx), 1, 1))
    Tt2D[:, 0, 2], Tt2D[:, 1, 2] = dx, dy
    Tt = np.linalg.inv(A2D) @ Tt2D @ A2D
    shift_x, shift_y = Tt[:, 0, 2], Tt[:, 1, 2]
    enable = (np.hypot(shift_x, shift_y) < max_shift_pixels) | (corr < 0)
    return shift_x, shift_y, enable


class ProgAlignTiltPairs(XmippProgram):
    name = "xmipp_image_align_tilt_pairs"

    def defineParams(self):
        self.addUsageLine("Center the tilted images of all tilted-untilted "
                          "image pairs (reference align_tilt_pairs.h:42-77).")
        self.addParamsLine("   -i <metadata> : Input metadata with untilted and tilted images")
        self.addParamsLine("   -o <metadata> : Output metadata with rotations & translations for 3D reconstruction")
        self.addParamsLine("   --ref <file> : 2D average of the untilted images")
        self.addParamsLine("  [--max_shift <value=10>] : Discard images shifting more than this (percentage of image size); 0 skips the shift estimate")
        self.addParamsLine("  [--do_stretch] : Stretch tilted image to fit the untilted one (thin particles)")
        self.addParamsLine("  [--do_not_align_tilted] : Do not align tilted images to untilted ones")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        ref = np.squeeze(Image(self.getParam("--ref")).data).astype(
            np.float32)
        max_shift = float(self.getDoubleParam("--max_shift"))
        do_stretch = self.checkParam("--do_stretch")
        rows, fns, A2D = [], [], []
        for _, r in MetaData(self.getParam("-i")).df.iterrows():
            flip = bool(r.get("flip", 0))
            in_plane_u = float(r.get("anglePsi", 0.0))
            alpha_u = float(r.get("angleY", 0.0))
            alpha_t = float(r.get("angleY2", 0.0))
            tilt = float(r.get("angleTilt", 0.0))
            shift_xu = float(r.get("shiftX", 0.0))
            shift_yu = float(r.get("shiftY", 0.0))
            fns.append(str(r.get("imageTilted", r.get("image_tilted", ""))))
            if flip:
                tilt += 180.0
                minus_in_plane_u = in_plane_u + alpha_u
            else:
                minus_in_plane_u = -(in_plane_u + alpha_u)
            A2D.append(stretch_matrix(flip, in_plane_u, shift_xu, shift_yu,
                                      alpha_t, alpha_u, tilt, do_stretch))
            # correct untilted alignment: Tup = E·Tu·E^-1
            E4 = np.eye(4)
            E4[:3, :3] = _euler4(minus_in_plane_u, tilt, alpha_t)
            Tu = np.eye(4)
            Tu[0, 3], Tu[1, 3] = shift_xu, shift_yu
            Tup = E4 @ Tu @ np.linalg.inv(E4)
            rows.append({"image": fns[-1], "angleRot": minus_in_plane_u,
                         "angleTilt": tilt, "anglePsi": alpha_t,
                         "shiftX": -Tup[0, 3], "shiftY": -Tup[1, 3]})
        n = len(rows)
        shift_x, shift_y = np.zeros(n), np.zeros(n)
        enable = np.ones(n, bool)
        if n and max_shift > 0 and \
                not self.checkParam("--do_not_align_tilted"):
            with timed_phase("center"):
                imgs_t = np.stack([np.squeeze(Image(fn).data) for fn in fns]
                                  ).astype(np.float32)
                shift_x, shift_y, enable = center_tilted_images(
                    ref, imgs_t, np.stack(A2D), max_shift, device=dev)
        for k, r in enumerate(rows):
            ok = bool(enable[k])
            r["shiftX"] += float(shift_x[k]) if ok else 0.0
            r["shiftY"] += float(shift_y[k]) if ok else 0.0
            r["enabled"] = int(ok)
        MetaData.fromRows(rows).write(self.getParam("-o"))
        self.n_discarded = int((~enable).sum())
        if self.verbose:
            print(f"  Discarded {self.n_discarded} images that shifted too "
                  f"much")
