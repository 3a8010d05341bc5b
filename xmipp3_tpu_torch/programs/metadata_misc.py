"""Metadata utility programs: split, import, histogram, angular distance
and rotation, EMX conversion.

The reference package's programs/metadata_misc.py, on the host as there:
these programs work on metadata columns with numpy, scipy and pandas (a
10,000-row table is a few hundred kilobytes) and touch no pixels, so they
use no device. angular_rotate composes its Euler matrices in float64,
where the reference's float32 matrices lose the in-plane angle of a view
at a pole (ROADMAP.md section 3, item 12).

Contracts: reference metadata_split, metadata_import, metadata_histogram,
angular_distance, angular_rotate, metadata_convert_emx.
"""
from __future__ import annotations

import numpy as np

from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram


class ProgMetadataSplit(XmippProgram):
    """Reference contract: metadata_split.cpp:52-200 — random/ordered split,
    --dont_sort/-l sort control, --dont_remove_disabled, and the
    --use_correlation AHC coocurrence split of reconstruct_significant
    cross-correlation volumes."""
    name = "xmipp_metadata_split"

    def defineParams(self):
        self.addUsageLine("Split a metadata into several parts.")
        self.addParamsLine("   -i <metadata>  : Input metadata")
        self.addParamsLine("  [-n <parts=2>]  : Number of output parts")
        self.addParamsLine("  [--oroot <root=\"\">] : Output rootname (default input name)")
        self.addParamsLine("  [--dont_randomize] : Keep input order")
        self.addParamsLine("  [--dont_sort] : Do not sort the output metadatas")
        self.addParamsLine("  [--dont_remove_disabled] : Keep disabled rows")
        self.addParamsLine("  [--use_correlation <fnCC=\"\"> <iter=100> <subset=16>] : Coocurrence AHC split on a reconstruct_significant correlation volume (single reference)")
        self.addParamsLine("  [-l <label=image>] : Sort using this label")
        self.addParamsLine("  [--seed <s=0>]  : Random seed")

    def run(self):
        import os
        fn = self.getParam("-i")
        md = MetaData(fn)
        n = self.getIntParam("-n")
        root = self.getParam("--oroot") or os.path.splitext(fn)[0]
        ext = os.path.splitext(fn)[1] or ".xmd"
        use_cc = self.checkParam("--use_correlation") and \
            self.getParam("--use_correlation", 0)
        if not self.checkParam("--dont_remove_disabled"):
            md.removeDisabled()
        idx = np.arange(len(md))
        if not self.checkParam("--dont_randomize") and not use_cc:
            rng = np.random.default_rng(self.getIntParam("--seed"))
            idx = rng.permutation(idx)
        n = min(n, len(md))
        if use_cc:
            parts = self._cc_split(str(use_cc), n)
        else:
            parts = np.array_split(idx, n)
        sort_label = (self.getParam("-l") if self.checkParam("-l")
                      else "image")
        for k, p in enumerate(parts):
            sub = MetaData(md.df.iloc[np.sort(np.asarray(p))]
                           .reset_index(drop=True))
            if not self.checkParam("--dont_sort") and \
                    sub.containsLabel(sort_label):
                sub.sort(sort_label)
            sub.write(f"{root}{k + 1:06d}{ext}")

    def _cc_split(self, fn_cc: str, n_groups: int) -> list[np.ndarray]:
        """AHC coocurrence split (metadata_split.cpp:131-180): cluster random
        direction-subsets of the correlation matrix repeatedly, accumulate a
        coocurrence matrix, then cluster its complement as a distance."""
        from scipy.cluster.hierarchy import fcluster, linkage
        from scipy.spatial.distance import squareform
        from xmipp3_tpu_torch.core.image import Image
        cc = np.asarray(Image(fn_cc).data, np.float64)
        if cc.ndim == 2:
            cc = cc[:, None, :]
        n_imgs, n_vols, n_dirs = cc.shape
        if n_vols != 1:
            from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
            raise XmippError(ErrCode.ARG_INCORRECT,
                             "--use_correlation needs a single-reference "
                             "correlation volume")
        iters = int(self.getIntParam("--use_correlation", 1))
        subset = min(int(self.getIntParam("--use_correlation", 2)), n_dirs)
        rng = np.random.default_rng(self.getIntParam("--seed"))
        co = np.zeros((n_imgs, n_imgs), np.int64)
        for _ in range(iters):
            cols = rng.permutation(n_dirs)[:subset]
            X = cc[:, 0, cols]
            lab = fcluster(linkage(X, method="ward"), n_groups,
                           criterion="maxclust")
            same = lab[:, None] == lab[None, :]
            co += same
        D = co.max() - co
        np.fill_diagonal(D, 0)
        lab = fcluster(linkage(squareform(D, checks=False),
                               method="complete"),
                       n_groups, criterion="maxclust")
        return [np.where(lab == g + 1)[0] for g in range(n_groups)]


class ProgMetadataImport(XmippProgram):
    name = "xmipp_metadata_import"

    def defineParams(self):
        self.addUsageLine("Import a plain text (columns) file as metadata.")
        self.addParamsLine("   -i <text_file>  : Input text file")
        self.addParamsLine("  [-o <metadata=\"\">] : Output metadata (stdout if absent)")
        self.addParamsLine("  [--labels <...>] : Label names of the columns (space-separated)")
        self.addParamsLine("   alias -l;")
        self.addParamsLine("   alias --columns;")
        self.addParamsLine("  [--merge <metadata=\"\">] : Merge the imported columns into this existing metadata")
        self.addParamsLine("   alias -m;")

    def run(self):
        labels = self.getListParam("--labels")
        if len(labels) == 1 and " " in labels[0]:
            labels = labels[0].split()
        rows = []
        with open(self.getParam("-i")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or line.startswith(";"):
                    continue
                toks = line.split()
                row = {}
                for lab, tok in zip(labels, toks):
                    try:
                        row[lab] = int(tok)
                    except ValueError:
                        try:
                            row[lab] = float(tok)
                        except ValueError:
                            row[lab] = tok
                rows.append(row)
        out = MetaData.fromRows(rows)
        if self.checkParam("--merge") and self.getParam("--merge"):
            base = MetaData(self.getParam("--merge"))
            if len(out) != len(base):
                from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
                raise XmippError(
                    ErrCode.MULTIDIM_SIZE,
                    f"--merge: imported file has {len(out)} rows but the "
                    f"merge target has {len(base)}; row counts must match")
            for lab in out.df.columns:
                base.df[lab] = out.df[lab].values
            out = base
        if self.checkParam("-o") and self.getParam("-o"):
            out.write(self.getParam("-o"))
        else:
            print(out.df.to_string(index=False))


class ProgMetadataHistogram(XmippProgram):
    name = "xmipp_metadata_histogram"

    def defineParams(self):
        self.addUsageLine("Histogram of a metadata column (1D or 2D).")
        self.addParamsLine("   -i <metadata>  : Input metadata")
        self.addParamsLine("   --col <label>  : Column to histogram")
        self.addParamsLine("  [-o <out=\"\">]   : Output metadata (stdout if absent)")
        self.addParamsLine("  [--steps <n=100>] : Number of bins")
        self.addParamsLine("  [--range <min> <max>] : Histogram range")
        self.addParamsLine("  [--col2 <label=\"\">] : Second column for a 2D histogram")
        self.addParamsLine("  [--range2 <m> <M>] : Range for the second column")
        self.addParamsLine("     requires --col2;")
        self.addParamsLine("  [--steps2 <N=100>] : Number of bins in the second column")
        self.addParamsLine("     requires --col2;")
        self.addParamsLine("  [--percentil <p=50.>] : Print this percentile (1D only)")
        self.addParamsLine("  [--write_as_image <image_file=\"\">] : Write the 2D histogram as an image")
        self.addParamsLine("     requires --col2;")

    def run(self):
        md = MetaData(self.getParam("-i"))
        vals = md.getColumn(self.getParam("--col")).astype(float)
        n = self.getIntParam("--steps")
        if self.checkParam("--range"):
            rng = (self.getDoubleParam("--range", 0),
                   self.getDoubleParam("--range", 1))
        else:
            rng = (float(vals.min()), float(vals.max()))
        col2 = (self.getParam("--col2")
                if self.checkParam("--col2") else "")
        if col2:
            vals2 = md.getColumn(col2).astype(float)
            n2 = (self.getIntParam("--steps2")
                  if self.checkParam("--steps2") else 100)
            if self.checkParam("--range2"):
                rng2 = (self.getDoubleParam("--range2", 0),
                        self.getDoubleParam("--range2", 1))
            else:
                rng2 = (float(vals2.min()), float(vals2.max()))
            H, ex, ey = np.histogram2d(vals, vals2, bins=(n, n2),
                                       range=(rng, rng2))
            self.hist2d = H
            if self.checkParam("--write_as_image") and \
                    self.getParam("--write_as_image"):
                from xmipp3_tpu_torch.core.image import save_image
                save_image(self.getParam("--write_as_image"),
                           H.astype(np.float32))
            cx = 0.5 * (ex[:-1] + ex[1:])
            cy = 0.5 * (ey[:-1] + ey[1:])
            rows = [{"x": float(cx[i]), "y": float(cy[j]),
                     "count": int(H[i, j])}
                    for i in range(n) for j in range(n2)]
            out = MetaData.fromRows(rows)
            if self.checkParam("-o") and self.getParam("-o"):
                out.write(self.getParam("-o"))
            return
        counts, edges = np.histogram(vals, bins=n, range=rng)
        centers = 0.5 * (edges[:-1] + edges[1:])
        if self.checkParam("--percentil"):
            p = self.getDoubleParam("--percentil")
            self.percentil = float(np.percentile(vals, p))
            print(f"percentil {p:g}%: {self.percentil:.6g}")
        out = MetaData.fromRows([{"x": float(c), "count": int(v)}
                                 for c, v in zip(centers, counts)])
        if self.checkParam("-o") and self.getParam("-o"):
            out.write(self.getParam("-o"))
        else:
            for c, v in zip(centers, counts):
                print(f"{c:14.6f} {v}")


class ProgAngularDistance(XmippProgram):
    name = "xmipp_angular_distance"

    def defineParams(self):
        self.addUsageLine("Angular distance between two angle assignments "
                          "(symmetry aware).")
        self.addParamsLine("   --ang1 <metadata> : First angle set")
        self.addParamsLine("   --ang2 <metadata> : Second angle set")
        self.addParamsLine("  [--oroot <root=\"\">] : Output rootname")
        self.addParamsLine("  [--sym <s=c1>]    : Symmetry group")
        self.addParamsLine("  [--check_mirrors] : Consider antipodal directions equal")
        self.addParamsLine("  [--object_rotation] : Compare full object "
                           "rotations (geodesic SO(3) distance) rather "
                           "than projection directions")
        self.addParamsLine("  [--compute_weights <minSigma=1> "
                           "<idLabel=particleId> <minSigmaD=-1>] : Weight "
                           "ang2 rows by a Gaussian of their angular (and, "
                           "with minSigmaD>0, shift) distance to ang1 "
                           "(reference computeWeights, "
                           "angular_distance.cpp:344-430); rewrites ang2 "
                           "and writes <oroot>_weights.xmd")
        self.addParamsLine("  [--set <set=1>] : Which diff/weight label "
                           "set to write (0/1/2 -> angleDiff0/angleDiff/"
                           "angleDiff2 + weightJumper*)")
        self.addParamsLine("  [--ang <ang=1>] : Angle set written in the "
                           "output rows (1 = ang1, 2 = ang2)")
        self.addParamsLine("  [--compute_average_angle] : Output rows "
                           "carry the average of both angle sets")
        self.addParamsLine("  [--compute_average_shift] : Output rows "
                           "carry the average of both shift sets")

    def _row_dist(self, a1, a2, mats, check_mirrors, object_rotation):
        """Per-row symmetric distance: directions (default) or SO(3)
        geodesic (--object_rotation). a* = (rot, tilt, psi)."""
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        from xmipp3_tpu_torch.core.sampling import directions_from_angles
        if not object_rotation:
            d1 = directions_from_angles(a1[:, :2])
            d2 = directions_from_angles(a2[:, :2])
            orbit = np.einsum("sij,nj->nsi", mats, d2)
            cos = np.einsum("ni,nsi->ns", d1, orbit).max(axis=1)
            if check_mirrors:
                cos = np.maximum(
                    cos, np.einsum("ni,nsi->ns", d1, -orbit).max(axis=1))
            return np.degrees(np.arccos(np.clip(cos, -1, 1)))
        R1 = np.asarray(euler_matrix(a1[:, 0].astype(np.float32),
                                     a1[:, 1].astype(np.float32),
                                     a1[:, 2].astype(np.float32)))
        R2 = np.asarray(euler_matrix(a2[:, 0].astype(np.float32),
                                     a2[:, 1].astype(np.float32),
                                     a2[:, 2].astype(np.float32)))
        # geodesic angle of R1 (S R2)^T, minimized over the orbit
        SR2 = np.einsum("sij,njk->nsik", mats, R2)
        tr = np.einsum("nik,nsik->ns", R1, SR2)
        best = tr.max(axis=1)
        if check_mirrors:
            M = np.diag([-1.0, 1.0, 1.0])
            SR2m = np.einsum("ij,nsjk->nsik", M, SR2)
            best = np.maximum(best, np.einsum(
                "nik,nsik->ns", R1, SR2m).max(axis=1))
        return np.degrees(np.arccos(np.clip((best - 1) / 2, -1, 1)))

    def run(self):
        from xmipp3_tpu_torch.core.sym import SymList
        md1 = MetaData(self.getParam("--ang1"))
        md2 = MetaData(self.getParam("--ang2"))
        sym = SymList(self.getParam("--sym") or "c1")
        mats = sym.sym_matrices().astype(np.float64)
        check_mirrors = self.checkParam("--check_mirrors")
        object_rotation = self.checkParam("--object_rotation")
        suffix = {0: "0", 1: "", 2: "2"}[self.getIntParam("--set")]
        if self.checkParam("--compute_weights"):
            return self._compute_weights(md1, md2, mats, check_mirrors,
                                         object_rotation, suffix)
        geta = lambda md: np.stack(
            [np.asarray(md.getColumn(c), float) if md.containsLabel(c)
             else np.zeros(md.size())
             for c in ("angleRot", "angleTilt", "anglePsi")], axis=1)
        gets = lambda md: np.stack(
            [np.asarray(md.getColumn(c), float) if md.containsLabel(c)
             else np.zeros(md.size()) for c in ("shiftX", "shiftY")],
            axis=1)
        a1, a2 = geta(md1), geta(md2)
        s1, s2 = gets(md1), gets(md2)
        ang = self._row_dist(a1, a2, mats, check_mirrors, object_rotation)
        shift_d = 0.5 * np.abs(s1 - s2).sum(axis=1)
        self.distances = ang
        if self.verbose:
            print(f"Mean angular distance: {ang.mean():.3f} deg "
                  f"(median {np.median(ang):.3f})")
        root = self.getParam("--oroot")
        if root:
            src = md2 if self.getIntParam("--ang") == 2 else md1
            rows = []
            for i, rid in enumerate(src):
                r = src.getRow(rid)
                if self.checkParam("--compute_average_angle"):
                    for k, c in enumerate(("angleRot", "angleTilt",
                                           "anglePsi")):
                        r[c] = 0.5 * (a1[i, k] + a2[i, k])
                if self.checkParam("--compute_average_shift"):
                    r["shiftX"] = 0.5 * (s1[i, 0] + s2[i, 0])
                    r["shiftY"] = 0.5 * (s1[i, 1] + s2[i, 1])
                r["angleDiff" + suffix] = float(ang[i])
                r["shiftDiff" + suffix] = float(shift_d[i])
                rows.append(r)
            MetaData.fromRows(rows).write(root + ".xmd")

    def _compute_weights(self, md1, md2, mats, check_mirrors,
                         object_rotation, suffix):
        """Gaussian jumper weights (angular_distance.cpp:344-430): per-id
        mean best-match distance, sigma over the population clamped at
        minSigma, weight = exp(-d^2/(2 sigma^2)) [* shift term]."""
        minSigma = float(self.getDoubleParam("--compute_weights"))
        idLabel = self.getParam("--compute_weights", 1)
        minSigmaD = float(self.getDoubleParam("--compute_weights", 2))
        rows1 = list(md1.iterRows())
        rows2 = list(md2.iterRows())
        by_id1 = {}
        for r in rows1:
            by_id1.setdefault(r.get(idLabel), []).append(r)
        by_id2 = {}
        for r in rows2:
            by_id2.setdefault(r.get(idLabel), []).append(r)
        a = lambda r: np.array([[float(r.get("angleRot", 0.0)),
                                 float(r.get("angleTilt", 0.0)),
                                 float(r.get("anglePsi", 0.0))]])
        s = lambda r: np.array([float(r.get("shiftX", 0.0)),
                                float(r.get("shiftY", 0.0))])
        diffs = {}
        for cid, grp2 in by_id2.items():
            grp1 = by_id1.get(cid)
            if not grp1:
                diffs[cid] = (-1.0, -1.0)
                continue
            cum = cumS = 0.0
            for r2 in grp2:
                best, bestS = 1e38, 1e38
                for r1 in grp1:
                    d = float(self._row_dist(a(r1), a(r2), mats,
                                             check_mirrors,
                                             object_rotation)[0])
                    if d < best:
                        best = d
                        bestS = 0.5 * np.abs(s(r1) - s(r2)).sum()
                cum += best
                cumS += bestS
            diffs[cid] = (cum / len(grp2), cumS / len(grp2))
        dvals = np.array([d for d, _ in diffs.values() if d > 0])
        svals = np.array([sd for d, sd in diffs.values() if d > 0])
        n = max(len(dvals), 1)
        sigma2 = max(minSigma ** 2, float((dvals ** 2).sum()) / n)
        sigma2D = max(minSigmaD ** 2, float((svals ** 2).sum()) / n) \
            if minSigmaD > 0 else 1.0
        if self.verbose:
            print(f"Sigma of angular distances={np.sqrt(sigma2):.4f}")
        out2 = []
        wrows = []
        for r in rows2:
            d, sd = diffs.get(r.get(idLabel), (-1.0, -1.0))
            w = 1.0
            if d >= 0:
                w *= float(np.exp(-0.5 * d * d / sigma2))
                if minSigmaD > 0:
                    w *= float(np.exp(-0.5 * sd * sd / sigma2D))
            else:
                w = 0.0
            rr = dict(r)
            rr["angleDiff" + suffix] = d
            rr["shiftDiff" + suffix] = sd
            rr["weightJumper" + suffix] = w
            out2.append(rr)
        MetaData.fromRows(out2).write(self.getParam("--ang2"))
        for cid, (d, sd) in diffs.items():
            wrows.append({idLabel: cid, "angleDiff" + suffix: d,
                          "shiftDiff" + suffix: sd})
        root = self.getParam("--oroot")
        if root:
            MetaData.fromRows(wrows).write(root + "_weights.xmd")


class ProgAngularRotate(XmippProgram):
    name = "xmipp_angular_rotate"

    def defineParams(self):
        self.addUsageLine("Apply a 3D rotation to a set of Euler angles "
                          "(reference angular_rotate.cpp grammar: --ang/"
                          "--euler/--alignZ/--axis rotation specs).")
        self.addParamsLine("   -i <metadata>  : Input angles")
        self.addParamsLine("  [-o <metadata=\"\">] : Output angles "
                           "(default: overwrite input)")
        self.addParamsLine("  [--rotate <rot=0> <tilt=0> <psi=0>] : "
                           "Rotation to compose")
        self.addParamsLine("     alias --euler;")
        self.addParamsLine("  [--ang <angle=0>] : In-plane rotation (deg, "
                           "about Z); overrides --rotate when given")
        self.addParamsLine("  [--alignZ <x=0> <y=0> <z=1>] : Rotation "
                           "aligning (x,y,z) with the Z axis")
        self.addParamsLine("  [--axis <ang=0> <x=0> <y=0> <z=1>] : Rotate "
                           "ang degrees about (x,y,z)")
        self.addParamsLine("  [--write_matrix] : Print the rotation matrix")

    def _rotation(self):
        from xmipp3_tpu_torch.core.geometry import (align_with_z,
                                                    rotation3d_matrix)
        if self.checkParam("--ang"):
            return _euler_matrix64(0.0, 0.0, self.getDoubleParam("--ang"))
        if self.checkParam("--alignZ"):
            axis = [self.getDoubleParam("--alignZ", k) for k in range(3)]
            return np.asarray(align_with_z(axis), np.float64)[:3, :3]
        if self.checkParam("--axis"):
            ang = self.getDoubleParam("--axis", 0)
            axis = [self.getDoubleParam("--axis", k + 1) for k in range(3)]
            return np.asarray(rotation3d_matrix(ang, axis),
                              np.float64)[:3, :3]
        return _euler_matrix64(self.getDoubleParam("--rotate", 0),
                               self.getDoubleParam("--rotate", 1),
                               self.getDoubleParam("--rotate", 2))

    def run(self):
        from xmipp3_tpu_torch.core.geometry import matrix_to_euler
        md = MetaData(self.getParam("-i"))
        R = self._rotation()
        if self.checkParam("--write_matrix"):
            print(np.array_str(R, precision=6))
        rows = []
        for i in md:
            r = md.getRow(i)
            A = _euler_matrix64(float(r.get("angleRot", 0)),
                                float(r.get("angleTilt", 0)),
                                float(r.get("anglePsi", 0)))
            rot, tilt, psi = matrix_to_euler(A @ R)
            r["angleRot"], r["angleTilt"], r["anglePsi"] = rot, tilt, psi
            rows.append(r)
        out = self.getParam("-o") or self.getParam("-i")
        MetaData.fromRows(rows).write(out)


def _euler_matrix64(rot, tilt, psi) -> np.ndarray:
    """core.geometry.euler_matrix's ZYZ matrix in float64. The reference
    composes float32 matrices here (metadata_misc.py:449-459): near a pole
    their 1e-7 noise becomes the 1e-6 tilt that matrix_to_euler reads, and
    the in-plane angle of a view at the pole is lost (ROADMAP.md section
    3, item 12)."""
    r, t, p = np.deg2rad([rot, tilt, psi])
    c1, s1, c2, s2, c3, s3 = (np.cos(r), np.sin(r), np.cos(t), np.sin(t),
                              np.cos(p), np.sin(p))
    return np.array([
        [c3 * c2 * c1 - s3 * s1, c3 * c2 * s1 + s3 * c1, -c3 * s2],
        [-s3 * c2 * c1 - c3 * s1, -s3 * c2 * s1 + c3 * c1, s3 * s2],
        [s2 * c1, s2 * s1, c2]])


PROGRAM = None


class ProgMetadataConvertEMX(XmippProgram):
    name = "xmipp_metadata_convert_emx"

    def defineParams(self):
        self.addUsageLine("Convert between EMX exchange files and .xmd "
                          "metadata (direction by extension).")
        self.addParamsLine("   -i <input>  : .emx or .xmd file")
        self.addParamsLine("   -o <output> : .xmd or .emx file")
        self.addParamsLine("  [--entity <e=particle>] : EMX entity on export/import")

    def run(self):
        from xmipp3_tpu_torch.core.emx import read_emx, write_emx
        fn_in = self.getParam("-i")
        fn_out = self.getParam("-o")
        entity = self.getParam("--entity")
        if fn_in.endswith(".emx"):
            tables = read_emx(fn_in)
            md = tables.get(entity) or next(iter(tables.values()))
            md.write(fn_out)
        else:
            write_emx(fn_out, MetaData(fn_in), entity)
