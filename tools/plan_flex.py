"""Plan the limits of chip_smoke.py phase 15 with the reference package on
the CPU: the phase's own recipes and readings (chip_smoke.flex_readings)
through the reference's programs.

- (a) The 8-blob phantom at --vol-n^3, deformed by planted Zernike3D
  coefficients (L1=3, L2=2) -> volume_deform_sph --analyzeStrain (the NCC
  and the RMS error of the fitted field over the phantom's mass),
  volume_apply_coefficient_zernike3d (against the warp that made the
  target), forward_zernike_volume (its NCC and field error).
- (b) --particles views of the phantom, each deformed by its own planted
  coefficients, at phase 4's first poses with the CTFs of phase 6's
  recipe at 2 A/px and noise, the rows' angles and shifts a little off ->
  angular_sph_alignment, forward_zernike_images --useCTF and
  forward_zernike_images_priors from its output (each: the mean CC, the
  coefficients' relative error, the median pose error).
- (c) Phase 12's 300-atom model, centred -> nma_modes --nmodes 3 ->
  pdb_nma_deform with planted amplitudes -> nma_alignment_vol on its
  rasterized map (the amplitudes' error), the package's
  fit_mode_amplitudes by Adam and by COBYQA; 8 views of the model
  deformed by their own amplitudes -> nma_alignment, with --projMatch
  (the reference's raises KeyError 'best_ref', ROADMAP.md section 3 item
  22: the plan adds that key to its matcher's result), and
  flexible_alignment (the amplitudes' RMS error, the mean CC).
- (d) 8 subtomograms at --sub-n^3 of the phantom splat with their own
  planted coefficients at random poses, wedge-masked ->
  forward_zernike_subtomos; 8 more of two states (+-c) ->
  forward_art_zernike3d_subtomos --useZernike --clusters 2; 2 x --art-views
  views of two states of the n^3 phantom with CTFs -> art_zernike3d and
  cuda11_forward_art_zernike3d --useZernike --useCTF --clusters 2 (each
  output's correlation with the phantom; the clusters split the states).

Run from the repo root on a CPU host with jax (about ten minutes at the
defaults, a few GB):

    JAX_PLATFORMS=cpu python tools/plan_flex.py [--n 64] [--vol-n 128]
        [--sub-n 64] [--particles 16] [--art-views 400] [--seed 0]
        [--package ref|port]

The card runs the phase at N=128: the reference's per-particle fits take
a padded 3-D FFT a particle and a step, too slow on a CPU at 128^3, so the
plan runs (b)-(d) at --n 64 and (a), the volume programs, at the card's
128^3 (at 64^3 the reference's forward_zernike_volume NCC fell 2.5e-5
short of 1, the card's at 128^3 7.8e-5: the size moves that reading). --package port runs the port's programs
instead, with --device cpu: the dry run of the phase's code on the CPU
(for example --n 32 --vol-n 32 --sub-n 32 --particles 4 --art-views 40,
a few minutes). Prints one
JSON line of the readings, each program's seconds and the limits: twice
the shortfall of a correlation r (1 - 2 (1 - r)), twice an error.
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
    part = lambda r: {"mean_cc": short(r["mean_cc"]),
                      "coeff_err": 2 * r["coeff_err"],
                      "pose_err_deg": 2 * r["pose_err_deg"]}
    out = {"deform_ncc": short(q["deform_ncc"]),
           "deform_field_err_px": 2 * q["deform_field_err_px"],
           "forward_volume_ncc": short(q["forward_volume_ncc"]),
           "nma_vol": {"amp_err": 2 * q["nma_vol"]["amp_err"],
                       "ncc": short(q["nma_vol"]["ncc"])},
           "subtomos": {"mean_cc": short(q["subtomos"]["mean_cc"]),
                        "coeff_err": 2 * q["subtomos"]["coeff_err"]}}
    out.update({k: part(q[k]) for k in ("sph", "fzi", "fzi_priors")})
    out.update({k: {"amp_rms_err": 2 * q[k]["amp_rms_err"],
                    "mean_cc": short(q[k]["mean_cc"])}
                for k in ("nma_alignment", "nma_alignment_projmatch",
                          "flexible_alignment")})
    out.update({k: {"corr": short(q[k]["corr"])}
                for k in ("art_subtomos", "art_zernike3d",
                          "cuda11_forward_art_zernike3d")})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--vol-n", type=int, default=cs.N)
    ap.add_argument("--sub-n", type=int, default=cs.FX_SUB_N)
    ap.add_argument("--particles", type=int, default=cs.FX_PARTICLES)
    ap.add_argument("--art-views", type=int, default=cs.FX_ART_VIEWS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--package", default="ref", choices=("ref", "port"))
    args = ap.parse_args()
    if args.package == "ref":
        import jax.numpy as jnp

        import xmipp3_tpu.ops.match as jmatch
        from xmipp3_tpu.models.nma import fit_mode_amplitudes
        from xmipp3_tpu.programs import get_program
        # the reference's nma_alignment --projMatch reads the winner as
        # "best_ref", a key its match_to_gallery does not return
        # (ROADMAP.md section 3, item 22): the plan adds it
        match = jmatch.match_to_gallery
        jmatch.match_to_gallery = lambda *a, **k: (
            lambda r: {**r, "best_ref": r["ref_idx"]})(match(*a, **k))
        tail = ["-v", "0"]
        fit = lambda vr, vt, c, m, o: fit_mode_amplitudes(
            jnp.asarray(vr), jnp.asarray(vt), c, m, optimizer=o)
    else:
        from xmipp3_tpu_torch.models.nma import fit_mode_amplitudes
        from xmipp3_tpu_torch.programs import get_program
        tail = ["-v", "0", "--device", "cpu"]
        fit = lambda vr, vt, c, m, o: fit_mode_amplitudes(
            vr, vt, c, m, optimizer=o, device="cpu")
    seconds = {}

    def run(label, name, argv):
        print(f"plan_flex: {label}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        prog = get_program(name)
        rc = prog.run_with_args([str(a) for a in argv] + tail)
        assert rc == 0, (label, rc)
        seconds[label] = time.perf_counter() - t0
        return prog

    with tempfile.TemporaryDirectory() as tmp:
        q, _ = cs.flex_readings(args.seed, Path(tmp), run, "cpu", n=args.n,
                                vol_n=args.vol_n, sub_n=args.sub_n,
                                particles=args.particles,
                                art_views=args.art_views, nma_fit=fit)
    print(json.dumps({"package": args.package, "n": args.n,
                      "vol_n": args.vol_n,
                      "sub_n": args.sub_n, "particles": args.particles,
                      "art_views": args.art_views, "readings": q,
                      "seconds": seconds, "limits": limits(q)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
