"""xmipp_transform_geometry — rotate/shift/scale/flip images and volumes, on
the card.

Contract: reference data/transform_geometry.{h,cpp} (grammar mirrored from
its defineParams; "--rotate: positive angle is a clockwise rotation").
Full flag surface: --matrix applies a user matrix directly
(transform_geometry.cpp:217-223), --apply_transform resamples pixels while
the default metadata path only rewrites the pose labels
(transform_geometry.cpp:313-316 transformationMatrix2Geo), --write_matrix
prints each composed matrix, --shift_to projects a 3-D target position
through the particle pose into the 2-D shifts
(transform_geometry.cpp:241-273), and --rotate_volume gains the
matrix/alignZ/icosahedral rotation types (calculateRotationMatrix).
The flags are those of the reference package's
programs/transform_geometry.py. The composed 3x3 matrices are built on
the host in float64; the resampling (B-spline by default) runs on the
card.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from xmipp3_tpu_torch.core.geometry import (align_with_z, euler_matrix,
                                            ico_setting_rotation,
                                            md_pose_from_matrix,
                                            transformation_matrix_from_string)
from xmipp3_tpu_torch.core.metadata_program import (XmippMetadataProgram,
                                                    is_metadata_file)
from xmipp3_tpu_torch.ops.geo import (alignment_matrices_2d, apply_affine_2d,
                                      apply_affine_3d,
                                      metadata_alignment_matrices)


class ProgTransformGeometry(XmippMetadataProgram):
    name = "xmipp_transform_geometry"
    apply_geo = True

    def defineProcessParams(self):
        self.addUsageLine("Apply geometric transformations to images/volumes.")
        self.addParamsLine("== Transformations ==")
        self.addParamsLine("[--rotate <ang=0>]   : Inplane rotation in 2D images (positive=clockwise)")
        self.addParamsLine("[--rotate_volume <rotation_type>] : Rotation of volumes")
        self.addParamsLine("         where <rotation_type>")
        self.addParamsLine("             euler <rot> <tilt> <psi>  : ZYZ Euler rotation")
        self.addParamsLine("             matrix <r11> <r12> <r13> <r21> <r22> <r23> <r31> <r32> <r33> : 3x3 rotation matrix, row-major")
        self.addParamsLine("             alignZ <x> <y> <z>        : Align (x,y,z) with the Z axis")
        self.addParamsLine("             axis <ang> <x=0> <y=0> <z=1> : Rotate around axis")
        self.addParamsLine("             icosahedral <from> <to>   : Rotate between icosahedral settings i1..i4")
        self.addParamsLine("[--scale <factor=1>]   : Scaling factor")
        self.addParamsLine(" alias -s;")
        self.addParamsLine("[--shift <x=0> <y=0> <z=0>] : Shift by x, y, z")
        self.addParamsLine("[--flip]               : Flip images (2D)")
        self.addParamsLine("[--matrix <...>]       : Apply directly this transformation matrix (9 or 16 values, row-major)")
        self.addParamsLine("== Other options ==")
        self.addParamsLine("[--interp <interpolation_type=spline>] : Interpolation")
        self.addParamsLine("      where <interpolation_type>")
        self.addParamsLine("        spline : cubic B-spline")
        self.addParamsLine("        linear : bilinear/trilinear")
        self.addParamsLine("[--inverse]            : Apply inverse transformation")
        self.addParamsLine("[--apply_transform]    : Resample pixels; default for metadata input is to rewrite pose labels only")
        self.addParamsLine("[--dont_wrap]          : Do not wrap around borders")
        self.addParamsLine("[--write_matrix]       : Print transformation matrix to screen")
        self.addParamsLine("[--shift_to <x=0> <y=0> <z=0>] : Shift each particle to x,y,z position")

    def readProcessParams(self):
        self.ang = self.getDoubleParam("--rotate") if self.checkParam("--rotate") else 0.0
        self.scale = self.getDoubleParam("--scale") if self.checkParam("--scale") else 1.0
        if self.checkParam("--shift"):
            self.shift = [self.getDoubleParam("--shift", i) for i in range(3)]
        else:
            self.shift = [0.0, 0.0, 0.0]
        self.flip = self.checkParam("--flip")
        self.order = 3 if (not self.checkParam("--interp") or
                           self.getParam("--interp") == "spline") else 1
        self.inverse = self.checkParam("--inverse")
        self.wrap = not self.checkParam("--dont_wrap")
        self.rotate_volume = (self.getListParam("--rotate_volume")
                              if self.checkParam("--rotate_volume") else None)
        self.apply_transform = self.checkParam("--apply_transform")
        self.write_matrix = self.checkParam("--write_matrix")
        self.user_matrix = (
            transformation_matrix_from_string(
                " ".join(self.getListParam("--matrix")))
            if self.checkParam("--matrix") else None)
        self.shift_to = ([self.getDoubleParam("--shift_to", i)
                          for i in range(3)]
                         if self.checkParam("--shift_to") else None)
        # row geometry is composed in matrix space here (ONE resampling,
        # like the reference's T = A*B), not pre-applied at load time
        self.compose_geo = self.do_apply_geo
        self.do_apply_geo = False

    def preProcess(self):
        # full float32: no TF32 in library products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # reference readParams/preProcess: metadata in, metadata (or no)
        # out, >1 row and no --apply_transform -> labels-only update
        self.metadata_only = (
            not self.apply_transform and not self.oroot
            and is_metadata_file(self.fn_in) and self.mdIn.size() > 1
            and (not self.fn_out or is_metadata_file(self.fn_out)))
        if self.metadata_only and not self.fn_out:
            # reference: no -o -> rewrite the input metadata in place
            self.fn_out = self.fn_in

    def _volume_matrix(self):
        toks = self.rotate_volume
        if toks[0] == "euler":
            return np.asarray(euler_matrix(*[float(t) for t in toks[1:4]]))
        if toks[0] == "matrix":
            return np.array([float(t) for t in toks[1:10]],
                            np.float64).reshape(3, 3)
        if toks[0] == "alignZ":
            return align_with_z([float(t) for t in toks[1:4]])
        if toks[0] == "icosahedral":
            return ico_setting_rotation(toks[1], toks[2])
        if toks[0] == "axis":
            ang = np.deg2rad(float(toks[1]))
            axis = np.array([float(t) for t in toks[2:5]], np.float64)
            axis = axis / np.linalg.norm(axis)
            K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            return (np.eye(3) + np.sin(ang) * K +
                    (1 - np.cos(ang)) * (K @ K)).astype(np.float32)
        raise ValueError(toks[0])

    # ------------------------------------------------------------------
    def _param_matrices_2d(self, B):
        """(B,3,3) parameter transform A (CLI flags only, no row geo)."""
        if self.user_matrix is not None:
            M = np.asarray(self.user_matrix, np.float64)
            if M.shape == (4, 4):
                M = np.array([[M[0, 0], M[0, 1], M[0, 3]],
                              [M[1, 0], M[1, 1], M[1, 3]],
                              [0, 0, 1]], np.float64)
            return np.broadcast_to(M, (B, 3, 3)).copy()
        ang = np.full(B, -self.ang, np.float32)
        A = alignment_matrices_2d(
            ang, np.full(B, self.shift[0], np.float32),
            np.full(B, self.shift[1], np.float32),
            flip=np.full(B, self.flip) if self.flip else None,
            scale=np.full(B, self.scale, np.float32),
            device="cpu").numpy().astype(np.float64)
        if self.inverse:
            A = np.linalg.inv(A)
        return A

    def _geo_matrices_2d(self, rows):
        """(B,3,3) per-row registration matrices from metadata pose."""
        psi = np.array([r.get("anglePsi", 0.0) or 0.0 for r in rows],
                       np.float32)
        sx = np.array([r.get("shiftX", 0.0) or 0.0 for r in rows],
                      np.float32)
        sy = np.array([r.get("shiftY", 0.0) or 0.0 for r in rows],
                      np.float32)
        flip = np.array([bool(r.get("flip", 0)) for r in rows])
        scale = np.array([float(r.get("scale", 1.0) or 1.0) for r in rows],
                         np.float32)
        return metadata_alignment_matrices(
            psi, sx, sy, flip, scale, device="cpu").numpy().astype(np.float64)

    def _shift_to_rows(self, rows):
        """--shift_to: target position projected through the particle pose
        into the image plane, accumulated into the 2-D shifts
        (transform_geometry.cpp:241-273)."""
        pos = np.asarray(self.shift_to, np.float64)
        posps = []
        for r in rows:
            R = np.asarray(euler_matrix(
                float(r.get("angleRot", 0.0) or 0.0),
                float(r.get("angleTilt", 0.0) or 0.0),
                float(r.get("anglePsi", 0.0) or 0.0)), np.float64)
            if self.inverse:
                R = R.T
            posp = R @ pos
            sx = float(r.get("shiftX", 0.0) or 0.0) + posp[0]
            sy = float(r.get("shiftY", 0.0) or 0.0) + posp[1]
            r["shiftX"] = sx
            r["shiftY"] = sy
            if "xcoor" in r:
                r["xcoor"] = int(r["xcoor"]) + int(sx)
            if "ycoor" in r:
                r["ycoor"] = int(r["ycoor"]) + int(sy)
            posps.append((posp[0], posp[1], sx, sy))
        return posps

    def processBatch(self, imgs, rows):
        B = imgs.shape[0]
        if imgs.ndim == 4 or (self.rotate_volume is not None):
            # volume path (always resamples, reference preProcess isVol)
            if self.user_matrix is not None:
                M4 = np.asarray(self.user_matrix, np.float64)
                M = M4[:3, :3] if M4.shape == (4, 4) else M4
            else:
                M = self._volume_matrix() if self.rotate_volume else np.eye(3)
                if self.inverse:
                    M = np.linalg.inv(M)
            if self.write_matrix:
                print(np.array2string(M, precision=6), file=sys.stderr)
            M = M.astype(np.float32)[None]
            return torch.stack([apply_affine_3d(v, M, wrap=self.wrap,
                                                device=self.device)[0]
                                for v in imgs])

        if self.shift_to is not None:
            posps = self._shift_to_rows(rows)
            if self.metadata_only:
                return imgs
            # pixels: apply only the accumulated shift, keep angles in md
            out = apply_affine_2d(
                imgs, np.array([[[1, 0, sx], [0, 1, sy], [0, 0, 1]]
                                for (_, _, sx, sy) in posps], np.float32),
                order=self.order, wrap=self.wrap, device=self.device)
            for r, (px, py, _, _) in zip(rows, posps):
                r["shiftX"] = -px
                r["shiftY"] = -py
            return out

        A = self._param_matrices_2d(B)
        if self.user_matrix is None and (self.compose_geo or
                                         self.apply_transform):
            A = A @ self._geo_matrices_2d(rows)
        if self.write_matrix:
            for M in A:
                print(np.array2string(M, precision=6), file=sys.stderr)
        if self.metadata_only:
            # rewrite the pose labels so that applying them later
            # reproduces the composed transform (transformationMatrix2Geo)
            for r, M in zip(rows, A):
                pose = md_pose_from_matrix(M)
                r["anglePsi"] = pose["psi"]
                r["shiftX"] = pose["x"]
                r["shiftY"] = pose["y"]
                r["flip"] = int(pose["flip"])
                if abs(pose["scale"] - 1.0) > 1e-6 or "scale" in r:
                    r["scale"] = pose["scale"]
            return imgs
        out = apply_affine_2d(imgs, A.astype(np.float32), order=self.order,
                              wrap=self.wrap, device=self.device)
        for r in rows:   # rowOut.resetGeo: pixels now carry the geometry
            for k, v in (("anglePsi", 0.0), ("shiftX", 0.0),
                         ("shiftY", 0.0), ("flip", 0)):
                if k in r:
                    r[k] = v
            if "scale" in r:
                r["scale"] = 1.0
        return out


PROGRAM = ProgTransformGeometry
