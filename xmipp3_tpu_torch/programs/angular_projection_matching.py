"""xmipp_angular_projection_matching — discrete 5-D (rot/tilt/psi/x/y)
projection matching against a gallery.

Contract: reference angular_projection_matching.{h,cpp}. The
pthread-per-image loop with an LRU reference cache becomes one batched
multireference alignment on the card — the gallery lives in device memory;
each particle batch is matched against ALL references by batched polar
correlation (K4, ops/cross.py) + shift refinement (no cache, no worker
state). Runs on the card unless `--device cpu` is given.

--mesh dp (auto = dp on more than one rank; slab and slab2d shard the
particles too) and --mesh tp run the matchers of parallel/match.py over the
ranks of a torch.distributed process group, started from
--dist_coordinator, --dist_nprocs and --dist_procid or by torchrun
(parallel/cli.py), with the reference's routing; only rank 0 writes files.

--ctf multiplies the gallery by a CTF before matching: a .ctfparam file
(its damped CTF, in absolute value under --phase_flipped) or a 2-D
amplitude image (centred), on the card like the rest.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import (BatchPrefetcher,
                                                    load_image_rows)
from xmipp3_tpu_torch.core.image import Image
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.ctf import CTFDescription
from xmipp3_tpu_torch.ops.geo import alignment_matrices_2d, apply_affine_2d
from xmipp3_tpu_torch.ops.match import N_ANGLES, match_to_gallery
from xmipp3_tpu_torch.parallel.cli import (add_mesh_params,
                                           maybe_init_distributed,
                                           read_mesh_params, resolve_mesh)
from xmipp3_tpu_torch.parallel.match import (parallel_match_full,
                                             parallel_match_tp)
from xmipp3_tpu_torch.parallel.mesh import backend, world


class ProgAngularProjectionMatching(XmippProgram):
    name = "xmipp_angular_projection_matching"

    def defineParams(self):
        self.addUsageLine("Assign angles by matching experimental images "
                          "against a projection gallery.")
        self.addParamsLine("   -i <md_file>  : Metadata with experimental images")
        self.addParamsLine("   -o <md_file>  : Output metadata with assignments")
        self.addParamsLine("   --ref <gallery_root> : Gallery rootname or .doc from angular_project_library")
        self.addParamsLine("     alias -r;")
        self.addParamsLine("  [--max_shift <s=-1>] : Maximum translation (pixels)")
        self.addParamsLine("  [--search5d_shift <s=0>] : 5D shift search range (compat; merged with max_shift)")
        self.addParamsLine("  [--search5d_step <s=-1>] : Step of the 5D shift search grid (px; <0 = max_shift/2)")
        self.addParamsLine("  [--Ri <r=1>]   : Inner polar radius")
        self.addParamsLine("  [--Ro <r=-1>]  : Outer polar radius (-1 = dim/2-2)")
        self.addParamsLine("  [--append]     : Append assignments to output metadata")
        self.addParamsLine("  [--number_orientations <n=1>] : Keep the N best orientations per image")
        self.addParamsLine("  [--max_angular_change <a=-1>] : Restrict candidate references to within this angular distance of the image's previous assignment (requires angleRot/angleTilt in the input)")
        self.addParamsLine("  [--neighbors <md=\"\">] : Per-image neighbor lists from angular_project_library --compute_neighbors (overrides --max_angular_change)")
        self.addParamsLine("  [--scale <step=1> <n_steps=0>] : Scale search: step factor (1 = 0.01 increments) and steps around 1")
        self.addParamsLine("     alias -s;")
        self.addParamsLine("  [--ctf <file=\"\">]  : CTF to apply to the references (.ctfparam or 2D amplitude image)")
        self.addParamsLine("  [--phase_flipped] : Experimental images are phase flipped")
        self.addParamsLine("  [--sym <symmetry=\"\">] : Symmetry group for "
                           "the --max_angular_change restriction (a "
                           "reference qualifies if ANY symmetry copy is "
                           "close; mpi_angular_projection_matching --sym)")
        self.addParamsLine("  [--batch <b=512>] : Particles per device batch")
        add_mesh_params(self)

    def readParams(self):
        self.device_arg = self.getParam("--device")
        self.fn_in = self.getParam("-i")
        self.fn_out = self.getParam("-o")
        self.fn_ref = self.getParam("--ref")
        self.max_shift = self.getIntParam("--max_shift")
        self.Ri = self.getIntParam("--Ri")
        self.Ro = self.getIntParam("--Ro")
        self.n_orient = self.getIntParam("--number_orientations")
        self.max_ang_change = self.getDoubleParam("--max_angular_change")
        self.fn_neighbors = self.getParam("--neighbors") \
            if self.checkParam("--neighbors") else ""
        self.scale_step = self.getDoubleParam("--scale", 0)
        self.scale_nsteps = self.getIntParam("--scale", 1)
        self.fn_ctf = self.getParam("--ctf") if self.checkParam("--ctf") \
            else ""
        self.phase_flipped = self.checkParam("--phase_flipped")
        self.batch = self.getIntParam("--batch")
        ts = self.getDoubleParam("--search5d_step")
        self.trial_step = ts if ts > 0 else None
        # hooks the discrete-assign subclass populates
        self.check_mirror = True
        self.max_psi_change = None
        self.psi_step = None
        self.sym = None
        if (self._grammar.canonical("--sym") and self.checkParam("--sym")
                and self.getParam("--sym")):
            from xmipp3_tpu_torch.core.sym import SymList
            self.sym = SymList(self.getParam("--sym"))
        read_mesh_params(self)

    def _extra_allowed(self, imgs, refs):
        """Optional per-batch candidate mask hook (B, R) — overridden by
        the wavelet-space discrete assignment."""
        return None

    def _apply_ctf_to_refs(self, refs):
        """Multiply the gallery (R, H, H) tensor by a CTF amplitude in
        Fourier space (the reference's --ctf path,
        programs/angular_projection_matching.py:87-105)."""
        H = refs.shape[-1]
        if self.fn_ctf.endswith(".ctfparam"):
            amp = CTFDescription.from_metadata(self.fn_ctf).generate_2d(
                H, H, rfft_layout=True, device=refs.device)
            if self.phase_flipped:
                amp = torch.abs(amp)
        else:
            amp = np.squeeze(Image(self.fn_ctf).data).astype(np.float32)
            amp = torch.as_tensor(np.ascontiguousarray(
                np.fft.ifftshift(amp)[:, : H // 2 + 1]), device=refs.device)
        return torch.fft.irfft2(torch.fft.rfft2(refs) * amp, s=(H, H))

    def _psi_allow(self, chunk):
        """Per-image psi search mask (B, N_ANGLES) from --psi_step /
        --max_psi_change (angular_discrete_assign.cpp grammar). Angles are
        in the engine's psi_align convention (stored psi_md = -psi_align,
        ops.geo.alignment_to_md_pose)."""
        if self.max_psi_change is None and self.psi_step is None:
            return None
        A = N_ANGLES
        keep = np.ones(A, bool)
        if self.psi_step is not None and self.psi_step > 0:
            stride = max(int(round(self.psi_step / (360.0 / A))), 1)
            keep &= (np.arange(A) % stride) == 0
        mask = np.broadcast_to(keep, (len(chunk), A)).astype(np.float32) \
            .copy()
        if self.max_psi_change is not None and self.max_psi_change >= 0:
            ang = np.arange(A) * (360.0 / A)
            psi0 = np.array([float(r.get("anglePsi", 0.0))
                             for r in chunk], np.float32)
            # condition |wrap(psi_md - psi0)| <= max with psi_md = -ang
            d = (-ang[None, :] - psi0[:, None] + 180.0) % 360.0 - 180.0
            mask *= (np.abs(d) <= self.max_psi_change + 1e-6)
            empty = mask.sum(axis=1) < 1
            if empty.any():
                mask[empty] = keep
        return mask

    def _match_with_scales(self, refs, imgs, max_shift, Ro, allowed,
                           psi_allow=None):
        """Match; optionally repeat over a scale grid and keep the best
        per image (reference scaleAlignOneImage, .h:176)."""
        def match(batch):
            r = match_to_gallery(refs, batch, max_shift=max_shift,
                                 radius_min=max(self.Ri, 2), radius_max=Ro,
                                 n_orientations=self.n_orient,
                                 allowed=allowed, psi_allow=psi_allow,
                                 check_mirror=self.check_mirror,
                                 trial_step=self.trial_step)
            r.pop("aligned", None)
            return {k: v.cpu().numpy() for k, v in r.items()}

        imgs = torch.as_tensor(imgs, device=refs.device)
        best = match(imgs)
        if self.scale_nsteps <= 0:
            return best
        B = imgs.shape[0]
        shp = best["corr"].shape
        best["scale"] = np.ones(shp, np.float32)
        step = 0.01 * self.scale_step
        scales = [1.0 + step * k for k in range(-self.scale_nsteps,
                                                self.scale_nsteps + 1)
                  if k != 0]
        z = torch.zeros(B, device=refs.device)
        for sc in scales:
            mats = alignment_matrices_2d(z, z, z,
                                         scale=torch.full_like(z, sc))
            r = match(apply_affine_2d(imgs, mats))
            better = r["corr"] > best["corr"]
            for key in ("ref_idx", "psi", "sx", "sy", "corr", "flip"):
                best[key] = np.where(better, r[key], best[key])
            best["scale"] = np.where(better, sc, best["scale"])
        return best

    def _match_batch(self, mesh, mesh_mode, refs, imgs, max_shift, Ro,
                     allowed, psi_allow):
        """The reference's routing (programs/angular_projection_matching.py
        :272-308): serial without a mesh or with a scale search; the
        particle-sharded matcher for dp (and slab modes) and for candidate
        masks, top-N or no mirrors; the gallery-sharded one for plain tp
        (tp with masks runs serially)."""
        masked = (self.n_orient > 1 or allowed is not None
                  or psi_allow is not None or not self.check_mirror)
        if mesh is None or self.scale_nsteps > 0 or \
                (mesh_mode == "tp" and masked):
            return self._match_with_scales(refs, imgs, max_shift, Ro,
                                           allowed, psi_allow)
        kw = dict(max_shift=max_shift, radius_min=max(self.Ri, 2),
                  radius_max=Ro)
        if mesh_mode == "tp":
            return parallel_match_tp(mesh, refs, imgs, **kw)
        if masked:
            kw.update(check_mirror=self.check_mirror, allowed=allowed,
                      psi_allow=psi_allow, n_orientations=self.n_orient)
        return parallel_match_full(mesh, refs, imgs, **kw)

    def run(self):
        self.device = resolve_device(self.device_arg)
        started = maybe_init_distributed(self)
        try:
            self._run()
        finally:
            if started:
                torch.distributed.destroy_process_group()

    def _run(self):
        mesh, mesh_mode = resolve_mesh(self.mesh_mode, device=self.device_arg)
        if mesh is not None:
            self.device = mesh.device
            if self.verbose:
                # parallel_match_* pad the particle axis to a mesh multiple
                print(f"mesh: {mesh_mode} {mesh.shape} over {mesh.size} "
                      f"ranks, rank {mesh.rank} on {self.device}, backend "
                      f"{backend()}")
        # the pipeline is full float32: no TF32 in library products (lower
        # precision in the correlations flips gallery winners)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        root = self.fn_ref
        for suffix in (".doc", ".stk"):
            if root.endswith(suffix):
                root = root[: -len(suffix)]
        md_ref = MetaData(root + ".doc")
        with timed_phase("read gallery"):
            refs = torch.as_tensor(load_image_rows(list(md_ref.iterRows())),
                                   device=self.device)
        ref_rot = md_ref.getColumn("angleRot").astype(np.float32)
        ref_tilt = md_ref.getColumn("angleTilt").astype(np.float32)
        if self.fn_ctf:
            # apply the CTF (amplitude) to the gallery (reference --ctf,
            # angular_projection_matching.cpp produceSideInfo)
            with timed_phase("ctf gallery", sync=refs):
                refs = self._apply_ctf_to_refs(refs)

        md_in = MetaData(self.fn_in)
        md_in.removeDisabled()
        rows = list(md_in.iterRows())
        H = refs.shape[-1]
        max_shift = self.max_shift if self.max_shift > 0 else H // 4
        Ro = self.Ro if self.Ro > 0 else H // 2 - 2

        # neighborhood restriction: previous assignment -> candidate mask
        # (reference Sampling neighbor lists, data/sampling.h:203; consumed
        # as a score mask over the dense gallery correlation)
        neighbor_map = None
        if self.fn_neighbors:
            md_nb = MetaData(self.fn_neighbors)
            neighbor_map = {}
            for r in md_nb.iterRows():
                lst = [int(v) - 1 for v in str(r["neighbors"]).split()]
                neighbor_map[str(r["image"])] = lst
        ref_dirs = None
        if neighbor_map is None and self.max_ang_change > 0:
            A = np.asarray(euler_matrix(ref_rot, ref_tilt,
                                        np.zeros_like(ref_rot)))
            ref_dirs = A[:, 2, :].astype(np.float64)
        Aall = np.asarray(euler_matrix(ref_rot, ref_tilt, np.zeros_like(ref_rot)))
        # gallery directions, for the discrete pick-1 clustering
        self._ref_dirs_all = Aall[:, 2, :].astype(np.float64)

        out_rows = []
        # double-buffered loader: the next batch reads while this one matches
        batches = iter(BatchPrefetcher(rows, self.batch,
                                       loader=load_image_rows))
        while True:
            with timed_phase("read images"):     # the wait for the loader
                item = next(batches, None)
            if item is None:
                break
            s, chunk, imgs = item
            allowed = self._extra_allowed(imgs, refs)
            if neighbor_map is not None:
                nb_allowed = np.zeros((len(chunk), len(refs)), np.float32)
                for i, r in enumerate(chunk):
                    lst = neighbor_map.get(str(r.get("image", "")), [])
                    if lst:
                        nb_allowed[i, lst] = 1.0
                    else:
                        nb_allowed[i] = 1.0
                allowed = nb_allowed if allowed is None \
                    else allowed * nb_allowed
            elif ref_dirs is not None:
                prot = np.array([float(r.get("angleRot", 0.0))
                                 for r in chunk], np.float32)
                ptilt = np.array([float(r.get("angleTilt", 0.0))
                                  for r in chunk], np.float32)
                Ai = np.asarray(euler_matrix(prot, ptilt,
                                             np.zeros_like(prot)))
                idirs = Ai[:, 2, :].astype(np.float64)
                if self.sym is not None and len(self.sym) > 1:
                    # --sym: a reference qualifies if ANY symmetry-
                    # equivalent image direction is close to it
                    mats = np.asarray(self.sym.sym_matrices(), np.float64)
                    isym = np.einsum("smn,bn->sbm", mats, idirs)
                    cosd = np.abs(np.einsum("sbm,rm->sbr", isym, ref_dirs))
                    cosd = np.clip(cosd.max(axis=0), -1.0, 1.0)
                else:
                    cosd = np.abs(np.clip(idirs @ ref_dirs.T, -1.0, 1.0))
                ang = np.degrees(np.arccos(cosd))  # mirror-symmetric
                prior_allowed = (ang <= self.max_ang_change) \
                    .astype(np.float32)
                allowed = prior_allowed if allowed is None \
                    else allowed * prior_allowed
            if allowed is not None:
                # never leave an image with zero candidates
                empty = allowed.sum(axis=1) < 1
                if empty.any():
                    allowed[empty] = 1.0
            psi_allow = self._psi_allow(chunk)
            with timed_phase("match_to_gallery"):
                res = self._match_batch(mesh, mesh_mode, refs, imgs,
                                        max_shift, Ro, allowed, psi_allow)
            def col(name):
                v = np.asarray(res[name])
                return v[:, None] if v.ndim == 1 else v
            ref_idx = col("ref_idx")
            psi = col("psi")
            if self.max_psi_change is not None and self.max_psi_change >= 0:
                # refinement may drift a little past the coarse-scan mask;
                # project back onto the allowed psi window
                psi0 = np.array([[float(r.get("anglePsi", 0.0))]
                                 for r in chunk], np.float32)
                d = (psi - psi0 + 180.0) % 360.0 - 180.0
                psi = psi0 + np.clip(d, -self.max_psi_change,
                                     self.max_psi_change)
            sx = col("sx")
            sy = col("sy")
            corr = col("corr")
            flip = col("flip")
            scl = col("scale") if "scale" in res else None
            for i, r in enumerate(chunk):
                for n in range(ref_idx.shape[1]):
                    d = dict(r)
                    k = int(ref_idx[i, n])
                    d.update({
                        "angleRot": float(ref_rot[k]),
                        "angleTilt": float(ref_tilt[k]),
                        "anglePsi": float(psi[i, n]),
                        "shiftX": float(sx[i, n]),
                        "shiftY": float(sy[i, n]),
                        "ref": k + 1,
                        "flip": int(flip[i, n]),
                        "maxCC": float(corr[i, n]),
                    })
                    if scl is not None:
                        d["scale"] = float(scl[i, n])
                    out_rows.append(d)
            if self.verbose:
                print(f"  matched {min(s + self.batch, len(rows))}/{len(rows)}")
        if world()[1] != 0:               # only rank 0 writes files
            return
        with timed_phase("write metadata"):
            md_out = MetaData.fromRows(out_rows)
            md_out.write(self.fn_out, append=self.checkParam("--append"))


PROGRAM = ProgAngularProjectionMatching
