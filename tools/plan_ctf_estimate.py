"""Plan the limits of chip_smoke.py phase 8 with the reference package on
the CPU: the same recipe (chip_smoke.est_data: micrograph A with one
defocus, micrograph B of 512 x 512 blocks on a tilted defocus plane,
particle positions, all at 1.34 A/px from --seed), through the reference's
programs:

  ctf_estimate_from_micrograph on A (micrograph mode), on B --mode regions,
  on A --mode particles; ctf_estimate_from_psd and
  ctf_estimate_from_psd_fast on A's .psd

and reads each fitted defocus against the plant. The default size is half
the phase's frame (2048 x 2048: B's 4 x 4 blocks are the same 16 regions,
at the same offsets from the centre, as the phase's interior ones; A's PSD
averages 49 tiles instead of 225) with 60 particles instead of 300, so
that the run stays small on a shared CPU.

Run from the repo root on a CPU host with jax:

    JAX_PLATFORMS=cpu python tools/plan_ctf_estimate.py [--size 2048]
        [--particles 60] [--seed 0]

Prints one JSON line of the numbers phase 8 checks: relative defocus
errors (the worse of U and V per region and per particle) and the
azimuth error in degrees.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--particles", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from xmipp3_tpu.core.image import save_image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.programs import get_program

    A, B, pos = cs.est_data(args.size, args.particles, args.seed)
    out = {"size": args.size, "particles": args.particles, "seed": args.seed,
           "seconds": {}}
    rel = lambda got, want: abs(got - want) / abs(want)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        f = lambda name: str(d / name)
        save_image(f("A.mrc"), A)
        save_image(f("B.mrc"), B)
        MetaData.fromRows({"xcoor": int(x), "ycoor": int(y)}
                          for x, y in pos).write(f("pos.xmd"))
        fit = ["--sampling_rate", str(cs.EST_TS), "--kV", str(cs.EST_KV),
               "--Cs", str(cs.EST_CS), "--Q0", str(cs.EST_Q0), "-v", "0"]
        runs = (
            ("micrograph", "ctf_estimate_from_micrograph",
             ["--micrograph", f("A.mrc"), "--oroot", f("A")]),
            ("regions", "ctf_estimate_from_micrograph",
             ["--micrograph", f("B.mrc"), "--oroot", f("B"), "--mode",
              "regions"]),
            ("particles", "ctf_estimate_from_micrograph",
             ["--micrograph", f("A.mrc"), "--oroot", f("P"), "--mode",
              "particles", f("pos.xmd")]),
            ("from_psd", "ctf_estimate_from_psd",
             ["--psd", f("A.psd"), "-o", f("A_fp.ctfparam")]),
            ("from_psd_fast", "ctf_estimate_from_psd_fast",
             ["--psd", f("A.psd"), "-o", f("A_fast.ctfparam")]))
        for label, name, argv in runs:
            t0 = time.perf_counter()
            assert get_program(name).run_with_args(argv + fit) == 0, label
            out["seconds"][label] = time.perf_counter() - t0
        row = lambda fn: (lambda md: md.getRow(md.firstObject()))(
            MetaData(fn))
        for key, fn in (("micrograph", "A.ctfparam"),
                        ("from_psd", "A_fp.ctfparam")):
            r = row(f(fn))
            out[key] = {"err_U": rel(r["ctfDefocusU"], cs.EST_A[0]),
                        "err_V": rel(r["ctfDefocusV"], cs.EST_A[1]),
                        "err_angle_deg": cs.est_angle_err(
                            r["ctfDefocusAngle"], cs.EST_A[2])}
        r = row(f("A_fast.ctfparam"))
        out["from_psd_fast"] = {"err_mean": rel(
            0.5 * (r["ctfDefocusU"] + r["ctfDefocusV"]),
            0.5 * (cs.EST_A[0] + cs.EST_A[1]))}
        md = MetaData(f("B_regions.xmd"))
        errs = []
        for i in md:
            g = md.getRow(i)
            u, v = cs.est_block_defocus(int(g["ycoor"]) // cs.EST_BLOCK,
                                        int(g["xcoor"]) // cs.EST_BLOCK,
                                        args.size)
            errs.append(max(rel(g["ctfDefocusU"], u),
                            rel(g["ctfDefocusV"], v)))
        r = row(f("B.ctfparam"))
        half = (cs.EST_A[0] - cs.EST_A[1]) / 2
        # the plane at the frame's centre: the blocks' plane passes through
        # EST_B_MEAN there at any size
        out["regions"] = {
            "count": len(errs), "max_err": max(errs),
            "median_err": float(np.median(errs)),
            "plane_err": max(rel(r["ctfDefocusU"], cs.EST_B_MEAN + half),
                             rel(r["ctfDefocusV"], cs.EST_B_MEAN - half))}
        md = MetaData(f("P_particles.xmd"))
        errs = []
        for i in md:
            r = row(md.getRow(i)["ctfModel"])
            errs.append(max(rel(r["ctfDefocusU"], cs.EST_A[0]),
                            rel(r["ctfDefocusV"], cs.EST_A[1])))
        out["particles"] = {"count": len(errs), "max_err": max(errs),
                            "p95_err": float(np.percentile(errs, 95)),
                            "median_err": float(np.median(errs))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
