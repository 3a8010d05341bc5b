"""xmipp_angular_project_library — generate a projection gallery over an even
angular sampling of the asymmetric unit, projected on the card.

Contract: reference angular_project_library (angular_project_library.h:47,
angular_project_library.cpp:100-146 grammar): writes <root>.stk (gallery) +
<root>.doc (angles metadata) + sampling file. Full option surface:
--psi_sampling in-plane ladder (cpp:203-223), --perturb direction noise
(cpp:274-279), --experimental_images/--near_exp_data/
--closer_sampling_points/--compute_neighbors/--only_winner neighborhood
machinery (cpp:315-345), --groups per-block sampling files
(createGroupSamplingFiles, cpp:409-462), --sym_neigh. Runs on the card unless
`--device cpu` is given.

--method is accepted and ignored, as in the reference package's program,
which declares it and always projects with FourierProjector.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.sampling import Sampling, directions_from_angles
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.project import FourierProjector


def _angles_from_directions(dirs: np.ndarray) -> np.ndarray:
    """Unit directions -> (rot, tilt) degrees (inverse of the A[2] row of
    the ZYZ passive Euler matrix)."""
    d = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True),
                          1e-12)
    tilt = np.degrees(np.arccos(np.clip(d[:, 2], -1.0, 1.0)))
    rot = np.degrees(np.arctan2(d[:, 1], d[:, 0]))
    return np.stack([rot, tilt], axis=1)


class ProgAngularProjectLibrary(XmippProgram):
    name = "xmipp_angular_project_library"

    def defineParams(self):
        self.addUsageLine("Create a gallery of projections from a volume over "
                          "an even sampling of the projection sphere.")
        self.addParamsLine("   -i <input_volume>     : Volume to project")
        self.addParamsLine("   -o <root_file_name>   : Output rootname (.stk/.doc)")
        self.addParamsLine("  [--sampling_rate <Ts=5>] : Angular distance between neighbors (deg)")
        self.addParamsLine("  [--sym <symmetry=c1>] : Symmetry group")
        self.addParamsLine("  [--sym_neigh <symmetry=\"\">] : symmetry used to "
                           "define neighbors (default: same as --sym)")
        self.addParamsLine("  [--psi_sampling <psi=360>] : sampling in psi; "
                           "360 -> no in-plane sampling")
        self.addParamsLine("  [--min_tilt_angle <t=0>]  : Minimum tilt")
        self.addParamsLine("  [--max_tilt_angle <t=180>] : Maximum tilt")
        self.addParamsLine("  [--perturb <sigma=0.0>] : gaussian noise on the "
                           "projection unit vectors")
        self.addParamsLine("  [--method <m=fourier>] : fourier | real_space (accepted; the gallery is always projected in Fourier space)")
        self.addParamsLine("  [--experimental_images <docfile=\"\">] : doc "
                           "file with experimental data")
        self.addParamsLine("  [--angular_distance <a=-1>] : Neighborhood radius (deg; required with --compute_neighbors)")
        self.addParamsLine("  [--compute_neighbors]  : Write per-gallery-direction neighbor lists (consumed by projection matching; reference Sampling::computeNeighbors, data/sampling.h:203)")
        self.addParamsLine("  [--near_exp_data]      : remove sampling points "
                           "far away from the experimental data")
        self.addParamsLine("  [--closer_sampling_points] : doc file with the "
                           "closest sampling point per experimental image")
        self.addParamsLine("  [--only_winner]        : each experimental point "
                           "keeps a unique (closest) neighbor")
        self.addParamsLine("  [--groups <selfile=\"\">] : selfile with groups; "
                           "per-block closest/neighbor files are written")
        self.addParamsLine("  [--batch <b=256>]      : Projections per device batch")

    def readParams(self):
        self.device_arg = self.getParam("--device")
        self.fn_vol = self.getParam("-i")
        self.fn_root = self.getParam("-o")
        if self.fn_root.endswith(".stk"):
            self.fn_root = self.fn_root[:-4]
        self.rate = self.getDoubleParam("--sampling_rate")
        self.sym = self.getParam("--sym")
        self.sym_neigh = self.getParam("--sym_neigh") or self.sym
        self.psi_sampling = self.getDoubleParam("--psi_sampling")
        self.tilt0 = self.getDoubleParam("--min_tilt_angle")
        self.tiltF = self.getDoubleParam("--max_tilt_angle")
        self.perturb = self.getDoubleParam("--perturb")
        self.fn_exp = self.getParam("--experimental_images")
        self.ang_dist = self.getDoubleParam("--angular_distance")
        self.near_exp = self.checkParam("--near_exp_data")
        self.closer = self.checkParam("--closer_sampling_points")
        self.only_winner = self.checkParam("--only_winner")
        self.fn_groups = self.getParam("--groups")
        self.batch = self.getIntParam("--batch")
        for flag, need in (("--near_exp_data", True), ("--closer_sampling_points", True)):
            if self.checkParam(flag) and not self.fn_exp:
                raise ValueError(f"{flag} requires --experimental_images")
        if self.checkParam("--compute_neighbors") and self.ang_dist <= 0:
            raise ValueError("--compute_neighbors requires "
                             "--angular_distance > 0")

    # -- experimental-data helpers ------------------------------------------
    def _exp_angles(self, fn=None):
        md_e = MetaData(fn or self.fn_exp)
        rows = list(md_e.iterRows())
        q = np.stack([[float(r.get("angleRot", 0.0)),
                       float(r.get("angleTilt", 0.0))] for r in rows])
        names = [str(r.get("image", i + 1)) for i, r in enumerate(rows)]
        return q, names

    def _filter_near_exp(self, angles):
        """--near_exp_data: keep sampling points within --angular_distance
        of any experimental direction (reference
        removePointsFarAwayFromExperimentalData)."""
        from xmipp3_tpu_torch.core.sampling import angular_distance_deg
        from xmipp3_tpu_torch.core.sym import SymList
        q, _ = self._exp_angles()
        d_exp = directions_from_angles(q)
        d_gal = directions_from_angles(angles[:, :2])
        sym = SymList(self.sym_neigh)
        if len(sym) > 1:
            mats = sym.sym_matrices().astype(np.float64)
            orbit = np.einsum("sij,nj->nsi", mats, d_exp)
            cos = np.einsum("nsi,mi->nsm", orbit, d_gal).max(axis=1)
        else:
            cos = d_exp @ d_gal.T
        ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        radius = self.ang_dist if self.ang_dist > 0 else self.rate * 2
        keep = (ang <= radius).any(axis=0)
        return angles[keep]

    def _write_closest(self, angles, fn_exp, root):
        """--closer_sampling_points: per experimental image, the winning
        sampling point (reference findClosestSamplingPoint,
        data/sampling.cpp:1991)."""
        from xmipp3_tpu_torch.core.sym import SymList
        q, names = self._exp_angles(fn_exp)
        d_exp = directions_from_angles(q)
        d_gal = directions_from_angles(angles[:, :2])
        sym = SymList(self.sym_neigh)
        if len(sym) > 1:
            mats = sym.sym_matrices().astype(np.float64)
            orbit = np.einsum("sij,nj->nsi", mats, d_exp)
            cos = np.einsum("nsi,mi->nsm", orbit, d_gal).max(axis=1)
        else:
            cos = d_exp @ d_gal.T
        winner = np.argmax(cos, axis=1)
        rows = []
        for i, w in enumerate(winner):
            rows.append({"image": names[i], "ref": int(w) + 1,
                         "angleRot": float(angles[w, 0]),
                         "angleTilt": float(angles[w, 1]),
                         "maxCC": float(cos[i, w])})
        MetaData.fromRows(rows).write(root + "_closest_sampling_points.xmd")

    def run(self):
        self.device = resolve_device(self.device_arg)
        # the pipeline is full float32: no TF32 in library products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        vol = np.squeeze(Image(self.fn_vol).data).astype(np.float32)
        sampling = Sampling(self.rate, self.sym, (self.tilt0, self.tiltF))
        angles = sampling.angles
        if self.perturb > 0:
            # gaussian noise on the unit vectors (reference setNoise,
            # data/sampling.cpp; deterministic seed like the reference's
            # my_seed for reproducible galleries)
            rng = np.random.default_rng(0)
            d = directions_from_angles(angles[:, :2])
            d = d + rng.normal(0.0, self.perturb, d.shape)
            angles = np.concatenate(
                [_angles_from_directions(d),
                 angles[:, 2:] if angles.shape[1] > 2 else
                 np.zeros((len(d), 0))], axis=1)
        if self.fn_exp and self.near_exp:
            angles = self._filter_near_exp(angles)
        if self.verbose:
            print(f"Projecting {len(angles)} directions (sym {self.sym}, "
                  f"{self.rate} deg)")
        with timed_phase("prepare volume"):
            projector = FourierProjector(vol, pad_factor=2.0,
                                         device=self.device)
        # psi ladder (reference project_angle_vector psi loop, cpp:203-223;
        # the reference's stack uses int(359.99999/psi) steps while its doc
        # loop emits ceil(360/psi) rows — we keep both consistent at the
        # full 360/psi coverage)
        psis = [0.0]
        if self.psi_sampling < 360:
            n_psi = max(int(round(360.0 / self.psi_sampling)), 1)
            psis = [k * self.psi_sampling for k in range(n_psi)]
        out = []
        for mypsi in psis:
            for s in range(0, len(angles), self.batch):
                a = angles[s:s + self.batch]
                with timed_phase("project"):
                    out.append(projector.project_euler(
                        a[:, 0].astype(np.float32), a[:, 1].astype(np.float32),
                        np.full(len(a), mypsi, np.float32)).cpu().numpy())
        gallery = np.concatenate(out)
        fn_stk = self.fn_root + ".stk"
        with timed_phase("write gallery"):
            save_image(fn_stk, gallery)
        rows = []
        cnt = 0
        for mypsi in psis:
            for a in angles:
                cnt += 1
                rows.append({"image": f"{cnt:06d}@{fn_stk}",
                             "angleRot": float(a[0]),
                             "angleTilt": float(a[1]),
                             "anglePsi": float(mypsi),
                             "itemId": cnt})
        md = MetaData.fromRows(rows)
        md.write(self.fn_root + ".doc")
        # sampling summary (reference writes a sampling file too)
        md_s = MetaData.fromRows([{"sampling_rate": self.rate,
                                   "symmetry": self.sym,
                                   "pointsAsymmetricUnit": len(angles)}])
        md_s.row_format = True
        md_s.write(self.fn_root + "_sampling.xmd", block="extra")
        if self.fn_exp and self.closer:
            self._write_closest(angles, self.fn_exp, self.fn_root)
        if self.checkParam("--compute_neighbors"):
            self._write_neighbors(angles, self.fn_exp, self.fn_root)
        if self.fn_groups:
            self._group_sampling_files(angles)
        if self.verbose:
            print(f"Gallery: {fn_stk} ({len(rows)} projections)")

    def _group_sampling_files(self, angles):
        """--groups: per-block closest/neighbor outputs with rootnames
        <root>_groupXXXXXX (reference createGroupSamplingFiles,
        angular_project_library.cpp:409-462)."""
        blocks = MetaData.blocksInFile(self.fn_groups)
        for igrp, blk in enumerate(blocks, start=1):
            root = f"{self.fn_root}_group{igrp:06d}"
            fn_blk = f"{blk}@{self.fn_groups}"
            if MetaData(fn_blk).size() == 0:
                continue
            if self.closer:
                self._write_closest(angles, fn_blk, root)
            if self.checkParam("--compute_neighbors"):
                self._write_neighbors(angles, fn_blk, root)

    def _write_neighbors(self, angles, fn_exp, root):
        """Neighbor lists (reference mysampling.computeNeighbors +
        my_neighbors output): one row per query direction with the
        space-separated gallery indices (1-based) within
        --angular_distance. Queries = --experimental_images rows when
        given (per-experimental-image neighborhoods), else the gallery
        itself. --only_winner keeps only the single closest index."""
        from xmipp3_tpu_torch.core.sampling import compute_neighbors
        from xmipp3_tpu_torch.core.sym import SymList
        ad = self.ang_dist
        if fn_exp:
            q, names = self._exp_angles(fn_exp)
        else:
            q = angles[:, :2]
            names = [str(i + 1) for i in range(len(angles))]
        sym = SymList(self.sym_neigh)
        nb = compute_neighbors(q, angles[:, :2], ad, sym)
        if self.only_winner:
            from xmipp3_tpu_torch.core.sampling import angular_distance_deg
            d_exp = directions_from_angles(q)
            d_gal = directions_from_angles(angles[:, :2])
            win = []
            for i, lst in enumerate(nb):
                if len(lst) == 0:
                    win.append(lst)
                    continue
                dist = angular_distance_deg(d_exp[i:i + 1], d_gal[lst])[0]
                win.append(lst[np.argmin(dist):np.argmin(dist) + 1])
            nb = win
        rows = []
        for i, lst in enumerate(nb):
            rows.append({"image": names[i],
                         "neighbors": " ".join(str(int(j) + 1)
                                               for j in lst),
                         "neighborCount": int(len(lst))})
        MetaData.fromRows(rows).write(root + "_neighbors.xmd")
        if self.verbose:
            counts = [len(l) for l in nb]
            print(f"neighbors: {len(rows)} rows, median "
                  f"{int(np.median(counts))} per direction "
                  f"(radius {ad} deg)")


PROGRAM = ProgAngularProjectLibrary
