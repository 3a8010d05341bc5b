"""Plan the limits of chip_smoke.py phase 17 with the reference package on
the CPU: the phase's own recipes and readings
(chip_smoke.tail_deep_readings, chip_smoke.tail_misc_readings) through
the reference's programs.

- (a) the deep programs, each trained through its CLI with --train:
  deep_consensus on particle and noise boxes (held-out accuracy),
  deep_global_assignment and _predict (the median angular error of
  held-out views), deep_micrograph_cleaner on a micrograph with a carbon
  strip (the mask's pixel accuracy), deep_hand on random blob sets and
  their mirrors (the probability of the right hand for a held-out set and
  its mirror), deepRes_resolution on maps of planted resolutions (the
  error of each zone's median), deep_misalignment_detection on aligned
  and turned subtomograms (held-out accuracy) and
  deep_volume_postprocessing on blurred, noisy maps (the output's
  correlation with the clean map);
- (b) compare_density, ctf_correct_wiener3d, the grey-level adjustment,
  volume_consensus, volumeset_align, the PDB programs, the micrograph
  programs (noisy zones, consensus, noise picks, preprocessing,
  extraction), the swiftalign pair, cl2d_clustering, align_pca_2d,
  metadata_split_3D, graph_max_cut, every matlab_bridge function and
  test_script_importing_module (compile where g++ is present).

Run from the repo root on a CPU host with jax:

    JAX_PLATFORMS=cpu python tools/plan_tail.py [--part deep|misc|both]
        [--n 64] [--boxes 1000] [--candidates 1000] [--ga-views 2000]
        [--mic 4096] [--hand-n 64] [--big-n 128] [--subtomos 200]
        [--set-n 64] [--views 2000] [--seed 0] [--package ref|port]

--part misalign [--draws 4] runs only the misalignment detector, on
--draws other draws of its recipe (numpy Generators seed + 1000 + k), and
prints their held-out accuracies and the limit from the worst of them
(about 4 minutes a draw for the reference).

At the defaults (the card's sizes) the deep part takes about 20 minutes
and a few GB on 8 cores, most of it the reference's 3-D training; the
misc part a few minutes. --package port runs the port's programs instead
with --device cpu: the dry run of the phase's code on the CPU (for
example --boxes 64 --candidates 32 --ga-views 64 --mic 1024 --hand-n 32
--big-n 64 --subtomos 16 --set-n 32 --views 200, about two minutes).
Prints one JSON line of the readings, each program's seconds and the
limits: twice the shortfall of an accuracy, probability, purity or
correlation r (1 - 2 (1 - r)), or half of r where that is higher, and
twice an error; the held-out accuracies of the trained classifiers count
their shortfall as at least one held-out sample.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402


def limits(q, held=None):
    """The limits of readings q. held: {reading: n} for the held-out
    accuracies of trained classifiers, whose shortfall is counted as at
    least one of their n samples (a reading of 1.0 on n samples cannot
    tell a shortfall below 1/n)."""
    held = held or {}
    short = lambda r, n=None: max(1 - 2 * max(1 - r, 1 / n if n else 0),
                                  r / 2)
    out = {}
    for k in ("consensus_acc", "cleaner_acc", "misalign_acc", "hand_p",
              "post_corr", "swift_purity", "cl2d_purity", "pca_avg_corr",
              "maxcut_agree", "wiener_corr", "consensus_corr"):
        if k in q:
            out[k] = short(q[k], held.get(k))
    if "hand_p_mirror" in q:          # a probability that should be low
        out["hand_p_mirror"] = 1 - short(1 - q["hand_p_mirror"])
    for k in ("ga_median_err_deg", "deepres_err_A", "grey_err",
              "volumeset_err_deg", "bridge_defocus_err"):
        if k in q:
            out[k] = 2 * q[k]
    if "compare_density" in q:
        out["compare_positive"] = short(q["compare_density"]["positive"])
    if "zones" in q:
        out["zones_band_removed"] = short(q["zones"]["band_removed"])
        out["zones_clear_kept"] = short(q["zones"]["clear_kept"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", default="both",
                    choices=("deep", "misc", "both", "misalign"))
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--n", type=int, default=cs.TL_N)
    ap.add_argument("--boxes", type=int, default=cs.TL_BOXES)
    ap.add_argument("--candidates", type=int, default=cs.TL_CANDIDATES)
    ap.add_argument("--ga-views", type=int, default=cs.TL_GA_VIEWS)
    ap.add_argument("--mic", type=int, default=cs.TL_MIC)
    ap.add_argument("--hand-n", type=int, default=cs.TL_HAND_N)
    ap.add_argument("--big-n", type=int, default=cs.TL_BIG_N)
    ap.add_argument("--subtomos", type=int, default=cs.TL_SUBTOMOS)
    ap.add_argument("--set-n", type=int, default=cs.TL_SET_N)
    ap.add_argument("--views", type=int, default=cs.TL_VIEWS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--package", default="ref", choices=("ref", "port"))
    args = ap.parse_args()
    if args.package == "ref":
        from xmipp3_tpu.programs import get_program
        tail = ["-v", "0"]
    else:
        from xmipp3_tpu_torch.programs import get_program
        tail = ["-v", "0", "--device", "cpu"]
    seconds = {}

    def run(label, name, argv):
        print(f"plan_tail: {label}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        prog = get_program(name)
        rc = prog.run_with_args([str(a) for a in argv] + tail)
        assert rc == 0, (label, rc)
        seconds[label] = time.perf_counter() - t0
        return prog

    if args.part == "misalign":
        # the detector's held-out accuracy on other draws of its recipe
        # (numpy Generators seed + 1000 + k): its spread across data and
        # the nets trained on them
        acc = []
        for k in range(args.draws):
            with tempfile.TemporaryDirectory() as tmp:
                acc.append(cs.misalign_readings(
                    np.random.default_rng(args.seed + 1000 + k), Path(tmp),
                    run, "cpu", args.subtomos)[0])
        n = 2 * args.subtomos
        print(json.dumps({"package": args.package, "part": "misalign",
                          "subtomos": args.subtomos, "accuracy": acc,
                          "seconds": seconds, "limit": limits(
                              {"misalign_acc": min(acc)},
                              {"misalign_acc": n})["misalign_acc"]}))
        return 0
    q = {}
    with tempfile.TemporaryDirectory() as tmp:
        if args.part in ("deep", "both"):
            (Path(tmp) / "deep").mkdir()
            qa, _ = cs.tail_deep_readings(
                args.seed, Path(tmp) / "deep", run, "cpu", n=args.n,
                boxes=args.boxes, candidates=args.candidates,
                ga_views=args.ga_views, mic=args.mic, hand_n=args.hand_n,
                big_n=args.big_n, subtomos=args.subtomos)
            q.update(qa)
        if args.part in ("misc", "both"):
            (Path(tmp) / "misc").mkdir()
            qb, _ = cs.tail_misc_readings(
                args.seed, Path(tmp) / "misc", run, "cpu", n=args.n,
                big_n=args.big_n, set_n=args.set_n, views=args.views,
                mic_size=args.mic)
            q.update({k: v for k, v in qb.items() if k != "data_s"})
    print(json.dumps({"package": args.package, **{
        k: getattr(args, k) for k in (
            "part", "n", "boxes", "candidates", "ga_views", "mic", "hand_n",
            "big_n", "subtomos", "set_n", "views")},
        "readings": q, "seconds": seconds, "limits": limits(q, {
            "consensus_acc": 2 * args.candidates,
            "misalign_acc": 2 * args.subtomos})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
