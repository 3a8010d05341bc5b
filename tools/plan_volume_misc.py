"""Plan the limits of chip_smoke.py phase 14 with the reference package on
the CPU: the phase's own recipes and readings
(chip_smoke.misc_volume_readings) through the reference's programs.

- Picking: two micrographs of --pick-size^2 at 1.34 A/px, each with
  --pick-views views of the 8-blob phantom at n at planted positions at
  least one box apart and noise of 1 sigma -> micrograph_scissor at the
  planted positions (against a numpy crop) and --extractNoise;
  micrograph_automatic_picking with 16 template views (recall and
  precision within a quarter box), --trainSVM on the scissor's boxes and
  noise boxes and --svm on the second micrograph, --mode buildinv /
  train on the first and autoselect on the second.
- The misc programs: transform_dimred on 1,000 of phase 10's views
  registered by their planted poses at 32^2 (PCA with --distance
  Euclidean against numpy's SVD; the default Correlation distance: the
  share of views nearest their direction's centroid); image_odd_even and
  angular_distribution_show on 2,000 of phase 4's views against numpy;
  transform_adjust_image_grey_levels on 2,000 clean views with a planted
  (a, b); transform_center_image on the views and on a copy moved by
  planted shifts (the error of the difference); transform_morphology
  against scipy.ndimage; local_volume_adjust on the --big-n^3 phantom with
  one block scaled by 1.5; volume_local_sharpening -k --sharp-k (the
  phase's 1; the program's default is 0.025) on a blurred --big-n^3
  density of blobs with a two-zone resolution map (each zone's lift of
  the energy above 0.2 cycles/px over its lift in 0.08-0.15).
- The volume programs at --vol-n^3: volume_from_pdb on phase 12's 300-atom
  model (the sums the phase holds the port to), volume_center on a planted
  shift, volume_align (grid, --local, --frm) on a planted rotation and
  shift, volume_subtraction --sub of the phantom with one blob removed,
  volume_segment, transform_mask, transform_symmetrize --sym c4 on a
  noisy C4 map, volume_to_pseudoatoms.

Run from the repo root on a CPU host with jax (a few minutes at the
defaults, a few GB):

    JAX_PLATFORMS=cpu python tools/plan_volume_misc.py [--n 128]
        [--pick-size 4096] [--pick-views 300] [--big-n 128] [--vol-n 64]
        [--sharp-k 1] [--seed 0] [--package ref|port]

--package port runs the port's programs instead, with --device cpu: the
dry run of the phase's code on the CPU (small sizes, for example
--pick-size 1024 --pick-views 30 --big-n 64, run in about a minute).
Prints one JSON line of the readings, each program's seconds and the
limits: twice the shortfall of a share or correlation r (1 - 2 (1 - r)),
twice an error, and for the C4 error ratio twice its distance from the
ideal 1/2 (four copies of white noise averaged) over 1/2.
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


def limits(q):
    short = lambda r: 1 - 2 * (1 - r)
    return {
        "PK_RECALL": {k: short(q["pick_" + k]["recall"])
                      for k in ("ref", "svm", "modes")},
        "PK_PRECISION": {k: short(q["pick_" + k]["precision"])
                         for k in ("ref", "svm", "modes")},
        "MS_DIMRED_SEP": short(q["dimred_corr_nearest_centroid"]),
        "MS_GREY_A": 2 * q["grey_a_err"], "MS_GREY_B": 2 * q["grey_b_err"],
        "MS_CENTER_PX": 2 * q["center_image_err_px"],
        "VL_PDB_SUM": q["from_pdb_sum"],
        "VL_CENTER_PX": 2 * q["volume_center_err_px"],
        "VL_SUB_RECOVERED": short(q["subtraction_recovered"]),
        "VL_SUB_REST": 2 * q["subtraction_rest"],
        "VL_SEGMENT_MASS": short(q["segment_mass"]),
        "VL_SYM_RATIO": 0.5 + 2 * abs(q["symmetrize_err_ratio"] - 0.5)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=cs.N)
    ap.add_argument("--pick-size", type=int, default=cs.PK_SIZE)
    ap.add_argument("--pick-views", type=int, default=cs.PK_VIEWS)
    ap.add_argument("--big-n", type=int, default=128)
    ap.add_argument("--vol-n", type=int, default=cs.VL_N)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharp-k", type=float, default=cs.MS_SHARP_K)
    ap.add_argument("--package", default="ref", choices=("ref", "port"))
    args = ap.parse_args()
    if args.package == "ref":
        from xmipp3_tpu.programs import get_program
        tail = ["-v", "0"]
    else:
        from xmipp3_tpu_torch.programs import get_program
        tail = ["-v", "0", "--device", "cpu"]
    n, seed = args.n, args.seed
    seconds = {}

    def run(label, name, argv):
        print(f"plan_volume_misc: {label}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        prog = get_program(name)
        rc = prog.run_with_args([str(a) for a in argv] + tail)
        assert rc == 0, (label, rc)
        seconds[label] = time.perf_counter() - t0
        return prog

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cls = root / "classify"
        cls.mkdir()
        cs.write_classify_data(cls, n, cs.CLS_VIEWS, seed, "cpu")
        p4, _ = cs.cycle_poses(seed)
        V = cs.MS_VIEWS
        p4 = {k: v[:V] * (n / cs.N if k in ("sx", "sy") else 1.0)
              for k, v in p4.items()}
        clean4 = cs.projections(n, p4["rot"], p4["tilt"], p4["psi"],
                                p4["sx"], p4["sy"],
                                cs.scaled_blobs(cs.BLOBS8, n), device="cpu")
        (root / "misc").mkdir()
        q = cs.misc_volume_readings(
            seed, root / "misc", run, "cpu", clean4, p4, cls, n=n,
            pick_size=args.pick_size, pick_views=args.pick_views,
            big_n=args.big_n, vol_n=args.vol_n, sharp_k=args.sharp_k)
    print(json.dumps({"package": args.package, "n": n,
                      "pick_size": args.pick_size,
                      "pick_views": args.pick_views, "big_n": args.big_n,
                      "vol_n": args.vol_n, "sharp_k": args.sharp_k,
                      "readings": q,
                      "seconds": seconds, "limits": limits(q)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
