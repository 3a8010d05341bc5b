"""Plan the limits of chip_smoke.py phase 16 with the reference package on
the CPU: the phase's own recipes and readings (chip_smoke.tomo_readings)
through the reference's programs.

- (a) Particles of two states of the 8-blob phantom (--box^3) on a grid
  in a --size x --size x --thickness tomogram, 12 gold beads at most (80
  A at 8 A/px) between them -> tomo_simulate_tilt_series (41 images over
  +-60 degrees, one run a state, summed) -> the dose filter, the landmark
  search (recall and precision against the planted beads), the residuals,
  the verdicts and their statistics -> tomogram_reconstruction (of the
  series with each image transposed: the reconstruction tilts about x,
  ROADMAP.md section 3, item 25), its correlation with the truth below
  0.1 cycles/px -> the missing wedge and the beads of the reconstruction,
  the beads of the simulated tomogram, the coordinates' statistics, extraction, the state's average, map back,
  subtraction, the Wiener correction of planted CTFs, tomo_project and
  the particle stacks.
- (b) classify_CLTomo_prog on --subtomos wedge-masked subtomograms at
  --sub-n^3 (purity against the states); classify_FTTRI on --fttri-views
  of phase 10's recipe at --n (purity against its 16 directions).
- (c) volume_initial_simulated_annealing at its defaults on
  --anneal-views of phase 4's views at --n; volume_align --frm
  --consider_mirror against the phantom (the correlation).
- (d) image_assignment_tilt_pair on 200 planted pairs, image_align_tilt_pairs
  on 200 tilted views of planted shifts, phantom_transform, volume_to_web,
  resolution_pdb_bfactor, performance_test and write_test.

Run from the repo root on a CPU host with jax (about ten minutes at the
defaults, a few GB):

    JAX_PLATFORMS=cpu python tools/plan_tomo.py [--size 256] [--thickness 96]
        [--box 64] [--particles 8] [--n 64] [--sub-n 64] [--subtomos 200]
        [--fttri-views 1000] [--anneal-views 500] [--seed 0]
        [--package ref|port]

The card runs the tomogram at 512 x 512 x 128 with 40 particles: the
reference's gridding of a 512^2 series holds three 1024^3 cubes and its
taps, too much for a shared CPU host, so the plan keeps the card's pixel
size, particle box and bead size in a 256^2 field of 8 particles; (b) and
(c) run at N=64 on fewer views. --package port runs the port's programs
instead, with --device cpu: the dry run of the phase's code on the CPU
(for example --size 96 --thickness 48 --box 24 --particles 4 --n 32
--sub-n 24 --subtomos 40 --fttri-views 96 --anneal-views 48, a few
minutes). Prints one JSON line of the readings, each program's seconds
and the limits: twice the shortfall of a correlation, recall, precision or
share r (1 - 2 (1 - r)) or half of r where that is higher, half the
directions won, twice an error.

--tomogram FILE reads the card's reconstruction instead, as
tools/phase_alone.py 16 --keep rec_truth.mrc saves it (the full 512 x 512
x 128, float16), times --scale, with --jitter times its std of numpy's
normal noise (drawn from --seed) added, and runs only the missing wedge
and the bead search on it (chip_smoke.wedge_and_beads; about a minute):

    JAX_PLATFORMS=cpu python tools/plan_tomo.py --tomogram FILE
        [--package ref|port] [--scale 1] [--jitter 0] [--seed 0]
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


def load_kept(path) -> np.ndarray:
    """A volume that tools/phase_alone.py --keep saved, as float32."""
    z = np.load(path)
    bits = (z["hi"].astype(np.uint16) << 8) | z["lo"]
    return bits.view(np.float16).astype(np.float32)


def wedge_and_beads(path, run, seed: int, scale: float = 1.0,
                    jitter: float = 0.0) -> dict:
    """The card's tomogram, times `scale`, plus numpy's normal noise of
    `jitter` times its std (drawn from seed), through the wedge and bead
    programs, against the fiducials that phase 16 plants at seed 0."""
    from xmipp3_tpu_torch.core.image import save_image
    vol = load_kept(path)
    if jitter:
        vol = vol + np.float32(jitter * vol.std()) * np.random.default_rng(
            seed).standard_normal(vol.shape, np.float32)
    vol = vol * np.float32(scale)
    thickness, size = vol.shape[0], vol.shape[1]
    fid_px = max(int(round(cs.TM_FID_A / cs.TM_TS)), 3)
    *_, fid = cs.tomo_geometry(0, size, thickness, cs.TM_BOX,
                               cs.TM_PARTICLES, cs.TM_FIDUCIALS, fid_px)
    with tempfile.TemporaryDirectory() as tmp:
        save_image(f"{tmp}/rec.mrc", vol)
        return cs.wedge_and_beads(
            run, f"{tmp}/rec.mrc", fid + [size // 2, size // 2,
                                          thickness // 2], fid_px)


def limits(q):
    # twice the shortfall, or half the reading where that is higher (a
    # reading far from 1)
    short = lambda r: max(1 - 2 * (1 - r), r / 2)
    rp = lambda d: {"recall": short(d["recall"]),
                    "precision": short(d["precision"])}
    return {"landmarks": rp(q["landmarks"]),
            "beads_truth": rp(q["beads_truth"]),
            "pairs": rp(q["pairs"]),
            "residuals_rms_px": 2 * q["residuals"]["rms_px"],
            "misalignment_enabled": short(q["misalignment_enabled"]),
            "tomogram_corr": short(q["tomogram_corr"]),
            "average_corr": short(q["average_corr"]),
            "map_back_mass": 2 * abs(q["map_back_mass"] - 1),
            "subtraction_energy": 2 * q["subtraction_energy"],
            "cltomo_purity": short(q["cltomo_purity"]),
            "fttri_purity": short(q["fttri_purity"]),
            "fttri_won": q["fttri_won"] // 2,
            "anneal_corr": short(q["anneal_corr"]),
            "align_pairs": {"enabled": short(q["align_pairs"]["enabled"]),
                            "shift_err_px":
                                2 * q["align_pairs"]["shift_err_px"]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--thickness", type=int, default=96)
    ap.add_argument("--box", type=int, default=cs.TM_BOX)
    ap.add_argument("--particles", type=int, default=8)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--sub-n", type=int, default=cs.TM_SUB_N)
    ap.add_argument("--subtomos", type=int, default=200)
    ap.add_argument("--fttri-views", type=int, default=1000)
    ap.add_argument("--anneal-views", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--package", default="ref", choices=("ref", "port"))
    ap.add_argument("--tomogram")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--jitter", type=float, default=0.0)
    args = ap.parse_args()
    if args.package == "ref":
        from xmipp3_tpu.programs import get_program
        tail = ["-v", "0"]
    else:
        from xmipp3_tpu_torch.programs import get_program
        tail = ["-v", "0", "--device", "cpu"]
    seconds = {}

    def run(label, name, argv):
        print(f"plan_tomo: {label}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        prog = get_program(name)
        rc = prog.run_with_args([str(a) for a in argv] + tail)
        assert rc == 0, (label, rc)
        seconds[label] = time.perf_counter() - t0
        return prog

    if args.tomogram:
        q = wedge_and_beads(args.tomogram, run, args.seed, args.scale,
                            args.jitter)
        print(json.dumps({"package": args.package, "tomogram":
                          args.tomogram, "scale": args.scale, "jitter":
                          args.jitter, "readings": q, "seconds": seconds}))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        q, _ = cs.tomo_readings(
            args.seed, Path(tmp), run, "cpu", size=args.size,
            thickness=args.thickness, box=args.box,
            particles=args.particles, sub_n=args.sub_n,
            subtomos=args.subtomos, fttri_views=args.fttri_views,
            n=args.n, anneal_views=args.anneal_views)
    print(json.dumps({"package": args.package, **{
        k: getattr(args, k) for k in (
            "size", "thickness", "box", "particles", "n", "sub_n",
            "subtomos", "fttri_views", "anneal_views")},
        "readings": q, "seconds": seconds, "limits": limits(q)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
