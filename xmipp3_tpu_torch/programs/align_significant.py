"""xmipp_align_significant — multireference alignment with significance
weighting, on the card.

Contract: the reference package's programs/align_significant.py
(reference AProgAlignSignificant, reconstruction/aalign_significant.
{h,cpp}:46-77, computeWeightsAndSave :283-311). Every experimental image
is scored against every reference (match_score_matrix, whose ring
correlations run through K4), in chunks of --batch images; the
correlation population becomes per-(image, reference) significance
weights: for each reference r the merits of all images against r's
angular neighbourhood (the references within --angDistance) are pooled
and ranked, and weight = merit / max_merit * cdf, the cdf being the
merit's rank in the pooled population. The --keepBestN best references of
each image are refined by refine_winners in --batch chunks.

Serial and --mesh dp runs score through parallel_match_score_matrix, which
deals the --batch chunks to the ranks in turn and gathers their scores, so
that every chunk is scored at the serial run's shape and the scores equal
the serial ones; the ranks then weight and
refine as the serial run does, and rank 0 writes. The reference declares
no --dist_* flags here: the ranks meet through torchrun's environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.parallel.cli import MeshProgram
from xmipp3_tpu_torch.parallel.match import parallel_match_score_matrix

# bytes of one group's pooled merits (values and int64 ranks) in
# significance_weights
SIGNIFICANCE_CHUNK_BYTES = 1 << 30


def significance_weights(cc, ref_dirs: np.ndarray, ang_distance: float,
                         device=None) -> torch.Tensor:
    """Per-(image, reference) significance weights (reference
    computeWeightsAndSave, aalign_significant.cpp:283-311) as a (B, R)
    float32 tensor on cc's device (an array goes to `device`, the card by
    default).

    For reference r the pooled merits are cc[:, neighbours of r] flattened
    in (image, neighbour) row-major order, ranked by a stable sort, so that
    tied merits get the reference's cdf; the references with the same
    neighbour count are ranked together, a group of rows at a time."""
    cc = as_tensor(cc, device)
    dev = cc.device
    B, R = cc.shape
    cosd = np.clip(ref_dirs @ ref_dirs.T, -1.0, 1.0)
    ang = np.degrees(np.arccos(cosd))
    nb = ang <= ang_distance
    nb[np.arange(R), np.arange(R)] = True
    W = torch.zeros((B, R), dtype=torch.float32, device=dev)
    counts = nb.sum(axis=1)
    for k in np.unique(counts):
        refs = np.flatnonzero(counts == k)
        n = B * int(k)
        if n < 2:
            W[:, refs] = torch.clamp(cc[:, refs], min=0.0)
            continue
        step = max(1, SIGNIFICANCE_CHUNK_BYTES // (12 * n))
        for s in range(0, len(refs), step):
            rs = refs[s:s + step]
            nb_idx = np.stack([np.flatnonzero(nb[r]) for r in rs])  # (G,k)
            pos_r = (nb_idx == rs[:, None]).argmax(axis=1)
            merits = cc[:, torch.as_tensor(nb_idx, device=dev)]     # (B,G,k)
            merits = merits.permute(1, 0, 2).reshape(len(rs), n)
            order = torch.sort(merits, dim=1, stable=True).indices
            rank = torch.empty_like(order)
            rank.scatter_(1, order, torch.arange(n, device=dev).expand(
                len(rs), n))
            cdf = rank.view(len(rs), B, int(k))[
                torch.arange(len(rs), device=dev), :,
                torch.as_tensor(pos_r, device=dev)]                  # (G,B)
            cdf = cdf.to(torch.float64) / (n - 1)
            max_merit = merits.max(dim=1).values
            inv_max = torch.where(max_merit > 0, 1.0 / max_merit, 0.0)
            m_r = cc[:, torch.as_tensor(rs, device=dev)].T           # (G,B)
            w = ((m_r * inv_max[:, None]).to(torch.float64) * cdf).to(
                torch.float32)
            W[:, torch.as_tensor(rs, device=dev)] = torch.where(
                m_r > 0, w, 0.0).T
    return W


class ProgAlignSignificant(MeshProgram):
    name = "xmipp_align_significant"

    def defineParams(self):
        self.addUsageLine("Find alignment of experimental images against a "
                          "set of references, with significance weighting.")
        self.addParamsLine("   -i <md_file>  : Metadata with experimental images")
        self.addParamsLine("   -r <md_file>  : Metadata with reference images (angleRot/angleTilt)")
        self.addParamsLine("   -o <md_file>  : Output metadata")
        self.addParamsLine("  [--angDistance <a=10>] : Angular distance defining each reference's neighborhood")
        self.addParamsLine("  [--keepBestN <N=1>]    : Store the N best alignments per image")
        self.addParamsLine("  [--useWeightInsteadOfCC] : Select the best reference by weight, not CC")
        self.addParamsLine("  [--oUpdatedRefs <baseName=\"\">] : Update references from the assignments and store here")
        self.addParamsLine("  [--max_shift <s=-1>]  : Maximum shift (pixels; -1 = dim/8)")
        self.addParamsLine("  [--batch <b=512>]     : Particles per device batch")
        self.addParamsLine("  [--mesh <mode=none>]  : Shard scoring over the device mesh (dp)")

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.fn_ref = self.getParam("-r")
        self.fn_out = self.getParam("-o")
        self.ang_distance = self.getDoubleParam("--angDistance")
        self.keep_n = self.getIntParam("--keepBestN")
        self.use_weight = self.checkParam("--useWeightInsteadOfCC")
        self.fn_updated = self.getParam("--oUpdatedRefs") \
            if self.checkParam("--oUpdatedRefs") else ""
        self.max_shift = self.getIntParam("--max_shift")
        self.batch = self.getIntParam("--batch")
        self.mesh_mode = self.getParam("--mesh") \
            if self.checkParam("--mesh") else "none"
        self.device_arg = self.getParam("--device")

    def _run(self, mesh):
        from xmipp3_tpu_torch.ops.match import refine_winners
        dev = self.device
        with timed_phase("read images"):
            md_ref = MetaData(self.fn_ref)
            ref_rows = list(md_ref.iterRows())
            refs_np = load_image_rows(ref_rows)
            md_in = MetaData(self.fn_in)
            md_in.removeDisabled()
            rows = list(md_in.iterRows())
            imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        refs = torch.as_tensor(refs_np, device=dev)
        rot = np.array([float(r.get("angleRot", 0)) for r in ref_rows],
                       np.float32)
        tilt = np.array([float(r.get("angleTilt", 0)) for r in ref_rows],
                        np.float32)
        A = np.asarray(euler_matrix(rot, tilt, np.zeros_like(rot)))
        dirs = A[:, 2, :].astype(np.float64)    # projection direction = A[2]
        H = refs.shape[-1]
        max_shift = self.max_shift if self.max_shift > 0 else max(H // 8, 2)
        R, B = len(refs), len(rows)

        with timed_phase("score", sync=refs):
            sm = parallel_match_score_matrix(mesh, refs, imgs, max_shift,
                                             batch=self.batch,
                                             verbose=self.verbose)
        cc = sm["peak"]
        with timed_phase("weights", sync=refs):
            W = significance_weights(cc, dirs, self.ang_distance)
            crit = W if self.use_weight else cc
            order = torch.sort(-crit, dim=1, stable=True).indices[
                :, :self.keep_n]                                 # (B, N)
        trials = torch.as_tensor(sm["trials"], device=dev)
        bi = torch.arange(B, device=dev)
        out_rows = []
        acc = torch.zeros_like(refs)
        acc_w = torch.zeros(R, dtype=torch.float64, device=dev)
        host = lambda t: t.cpu().numpy()
        W_np, cc_np = host(W), host(cc)
        for n in range(self.keep_n):
            rk = order[:, n]
            res = {k: [] for k in ("psi", "sx", "sy", "flip")}
            with timed_phase("refine", sync=refs):
                for s in range(0, B, self.batch):
                    sl = slice(s, s + self.batch)
                    k_s, b_s = rk[sl], bi[sl]
                    out = refine_winners(
                        refs, imgs[sl], k_s, sm["psi"][b_s, k_s],
                        trials[sm["trial"][b_s, k_s]], sm["flip"][b_s, k_s],
                        max_shift, 2, H // 2 - 2)
                    for key in res:
                        res[key].append(out[key])
                    if n == 0 and self.fn_updated:
                        w = W[b_s, k_s]
                        acc.index_add_(0, k_s, out["aligned"]
                                       * w[:, None, None])
                        acc_w.index_add_(0, k_s, w.to(torch.float64))
            res = {k: host(torch.cat(v)) for k, v in res.items()}
            rk_np = host(rk)
            for i, r in enumerate(rows):
                k = int(rk_np[i])
                d = dict(r)
                d.update({
                    "angleRot": float(rot[k]), "angleTilt": float(tilt[k]),
                    "anglePsi": float(res["psi"][i]),
                    "shiftX": float(res["sx"][i]),
                    "shiftY": float(res["sy"][i]),
                    "ref": k + 1, "flip": int(res["flip"][i]),
                    "maxCC": float(cc_np[i, k]),
                    "weight": float(W_np[i, k]),
                    "weightSignificant": float(W_np[i, k]),
                })
                out_rows.append(d)
        self.weights = W_np
        if not self.writer:               # only rank 0 writes files
            return
        with timed_phase("write outputs"):
            MetaData.fromRows(out_rows).write(self.fn_out)
            if self.fn_updated:
                upd = refs.clone()
                has = acc_w > 1e-8
                upd[has] = (acc[has].to(torch.float64)
                            / acc_w[has][:, None, None]).to(torch.float32)
                stk = self.fn_updated + ".stk"
                save_image(stk, host(upd))
                acc_w_np = host(acc_w)
                ref_out = []
                for k, r in enumerate(ref_rows):
                    d = dict(r)
                    d["image"] = f"{k + 1:06d}@{stk}"
                    d["weight"] = float(acc_w_np[k])
                    ref_out.append(d)
                MetaData.fromRows(ref_out).write(self.fn_updated + ".xmd")
        if self.verbose:
            print(f"aligned {B} images against {R} references "
                  f"(keepBestN={self.keep_n})")


PROGRAM = ProgAlignSignificant
