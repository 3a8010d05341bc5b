"""Probe how ml_align2d and mlf_align2d classify a subset of chip_smoke.py
phase 10's views: the recipe drawn for --recipe views (seed --seed), then
--views of them, either the first ones (--take first, as a prefix of the
recipe) or an equal share of each of the CLS_CTF_GROUPS CTF groups
(--take groups; the recipe gives the groups contiguous blocks of
ceil(recipe / groups) views, so a prefix shorter than one block holds one
defocus only). Each program runs as phase 10 runs it (--nref 16 --mirror
--iter 10; MLF2D with --sampling_rate) and the readings are phase 10's:
purity, directions won and the class averages' median correlation with
their direction's clean image.

Run from the repo root, the port on the card (or --device cpu), or the
reference package on the CPU (--package ref, needs jax):

    python tools/probe_ml_subset.py --recipe 4096 --views 1000 \
        [--take first|groups] [--seed 0] [--package port|ref] \
        [--device cuda] [--programs mlf2d ml2d]

Prints one JSON line per program.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PROGRAMS = {"ml2d": ("ml_align2d", "views.xmd", []),
            "mlf2d": ("mlf_align2d", "ctf_views.xmd",
                      ["--sampling_rate", cs.CTF_TS])}


def subset(recipe: int, views: int, take: str) -> np.ndarray:
    """Indices (0-based) of the views taken from the recipe."""
    if take == "first":
        return np.arange(views)
    per = -(-recipe // cs.CLS_CTF_GROUPS)
    share = views // cs.CLS_CTF_GROUPS
    return np.concatenate([np.arange(g * per, g * per + share)
                           for g in range(cs.CLS_CTF_GROUPS)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", type=int, default=cs.CLS_VIEWS)
    ap.add_argument("--views", type=int, default=1000)
    ap.add_argument("--take", choices=("first", "groups"), default="first")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--package", choices=("port", "ref"), default="port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--programs", nargs="+", choices=tuple(PROGRAMS),
                    default=["mlf2d"])
    args = ap.parse_args()
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.core.metadata import MetaData
    if args.package == "ref":
        from xmipp3_tpu.programs import get_program
        tail, data_device = ["--mesh", "none"], "cpu"
    else:
        from xmipp3_tpu_torch.programs import get_program
        tail, data_device = ["--device", args.device], args.device
    pick = subset(args.recipe, args.views, args.take)
    per = -(-args.recipe // cs.CLS_CTF_GROUPS)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        data = cs.write_classify_data(d, cs.N, args.recipe, args.seed,
                                      data_device)
        label, classes = np.asarray(data["label"]), data["classes"]
        for lab in args.programs:
            name, inp, extra = PROGRAMS[lab]
            md = MetaData(str(d / inp))
            rows = [md.getRow(i) for i in md]
            MetaData.fromRows([rows[i] for i in pick]).write(
                str(d / f"{lab}_in.xmd"))
            t0 = time.perf_counter()
            rc = get_program(name).run_with_args(
                [str(a) for a in ["-i", d / f"{lab}_in.xmd", "--nref",
                                  cs.CLS_NREF, "--mirror", "--iter",
                                  cs.CLS_ITER, "--oroot", d / lab, *extra,
                                  *tail, "-v", 0]])
            wall = time.perf_counter() - t0
            assert rc == 0, (name, rc)
            out = MetaData(str(d / f"{lab}_images.xmd"))
            got = sorted((out.getRow(i) for i in out),
                         key=lambda r: r["itemId"])
            item = np.array([int(r["itemId"]) for r in got]) - 1
            assign = np.array([int(r["ref"]) for r in got]) - 1
            pur, won = cs.class_purity(assign, label[item])
            refs = Image.read_stack(str(d / f"{lab}_references.stk"))
            corr = cs.average_corr(refs, classes, cs.majorities(
                assign, label[item], cs.CLS_NREF), data_device)
            print(json.dumps({
                "program": name, "package": args.package,
                "recipe": args.recipe, "views": len(pick),
                "take": args.take, "seed": args.seed,
                "ctf_groups": sorted({int(i // per) for i in pick}),
                "purity": pur, "directions_won": won,
                "avg_corr_median": float(np.median(corr)),
                "wall_s": wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
