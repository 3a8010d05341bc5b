"""Run one of chip_smoke.py's later phases alone on the card, with every
check: the kernels are built, then

- 14: phase 14's inputs are made as phases 4 and 10 make them (phase 10's
  4,096 views and poses on disk, the first 2,000 of phase 4's clean views
  and true poses), and chip_smoke.misc_and_volumes runs the 18 programs
  of the micrograph, misc and volume slices;
- 15: chip_smoke.flexibility runs the 16 programs of the Zernike3D and
  NMA slice;
- 16: chip_smoke.tomography runs the 28 programs of the tomography slice,
  the tail of flex_misc_ext and the three tilt programs;
- 17: chip_smoke.tail runs the long tail: the deep programs, the rest of
  final_batch and scripts_misc, matlab_bridge and the infra programs;
- 18: the inputs that phase 18 reads of phases 4 and 6 are made as those
  phases make them, the assignment being the true poses (phase 4's
  phantom, 5-degree gallery and views; phase 6's 20 .ctfparam files and
  CTF views with their rows; phase 8's micrograph A), and
  chip_smoke.binding_surface drives the binding.

Phases 15-17 make their own data; they read nothing of the earlier
phases. On the card, from the repo root:

    python3 tools/phase_alone.py 16 [--keep rec_truth.mrc ...]

The data go under chip_smoke_data/p<phase>/, removed at the end. --keep
copies a volume of the data folder, as float16 (its high and low bytes
apart, so that zlib packs the exponents), to
chiprun_out/p<phase>_<name>.npz: tools/plan_tomo.py --tomogram reads it.
The dry run of a phase's code on the CPU is its plan with --package port
(tools/plan_volume_misc.py, tools/plan_flex.py, tools/plan_tomo.py,
tools/plan_tail.py).
"""
import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def misc_volume(root: Path):
    cls = root / "classify"
    cls.mkdir(parents=True)
    t0 = time.perf_counter()
    cs.write_classify_data(cls, cs.N, cs.CLS_VIEWS, 0, cs.DEVICE)
    p4, _ = cs.cycle_poses(0)
    p4 = {k: v[:cs.MS_VIEWS] for k, v in p4.items()}
    clean = cs.projections(cs.N, p4["rot"], p4["tilt"], p4["psi"],
                           p4["sx"], p4["sy"], cs.BLOBS8, device=cs.DEVICE)
    print(f"inputs in {time.perf_counter() - t0:.2f} s", flush=True)
    cs.misc_and_volumes(0, root / "misc", cls, clean, p4)


def binding(root: Path):
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    from xmipp3_tpu_torch.programs import get_program
    cycle, ctf = root / "cycle", root / "ctf"
    cycle.mkdir(parents=True)
    ctf.mkdir()
    t0 = time.perf_counter()
    save_image(str(cycle / "phantom.vol"), cs.phantom(cs.N, cs.BLOBS8))
    rc = get_program("angular_project_library").run_with_args([
        "-i", str(cycle / "phantom.vol"), "-o", str(cycle / "gallery"),
        "--sampling_rate", str(cs.GALLERY_RATE), "--device", cs.DEVICE,
        "-v", "0"])
    cs.check(rc == 0, f"phase 18's gallery: rc {rc}")
    p, rng = cs.cycle_poses(0)
    clean = cs.projections(cs.N, p["rot"], p["tilt"], p["psi"], p["sx"],
                           p["sy"], cs.BLOBS8, device=cs.DEVICE)
    save_image(str(cycle / "views.mrcs"), clean)
    MetaData.fromRows(
        {"image": f"{i + 1}@{cycle / 'views.mrcs'}", "itemId": i + 1,
         "angleRot": float(p["rot"][i]), "angleTilt": float(p["tilt"][i]),
         "anglePsi": float(p["psi"][i]), "shiftX": float(p["sx"][i]),
         "shiftY": float(p["sy"][i]), "flip": False}
        for i in range(cs.VIEWS)).write(str(cycle / "assigned.xmd"))
    per = cs.VIEWS // cs.CTF_GROUPS
    models = []
    for g, (u, v, az) in enumerate(zip(*cs.ctf_recipe())):
        models.append(str(ctf / f"mic{g:02d}.ctfparam"))
        CTFDescription(sampling_rate=cs.CTF_TS, voltage=cs.CTF_KV,
                       defocusU=float(u), defocusV=float(v),
                       azimuthal_angle=float(az), Cs=cs.CTF_CS,
                       Q0=cs.CTF_Q0).write(models[-1])
    save_image(str(ctf / "ctf_clean.mrcs"), cs.ctf_stack(clean))
    MetaData.fromRows(
        {"image": f"{i + 1}@{ctf / 'ctf_clean.mrcs'}",
         "ctfModel": models[i // per]} for i in range(cs.VIEWS)).write(
        str(ctf / "true_model.xmd"))
    save_image(str(root / cs.BD_MIC), cs.est_plant(
        cs.EST_SIZE, cs.EST_TS, *cs.EST_A, np.random.default_rng(0)))
    print(f"inputs in {time.perf_counter() - t0:.2f} s", flush=True)
    cs.binding_surface(0, root / "binding", cycle, ctf, root / cs.BD_MIC)


PHASES = {14: misc_volume,
          15: lambda root: cs.flexibility(0, root),
          16: lambda root: cs.tomography(0, root),
          17: lambda root: cs.tail(0, root),
          18: binding}


def keep(src: Path, dst: Path):
    from xmipp3_tpu_torch.core.image import Image
    bits = np.squeeze(Image(str(src)).data).astype(np.float16).view(np.uint16)
    np.savez_compressed(dst, hi=(bits >> 8).astype(np.uint8),
                        lo=(bits & 255).astype(np.uint8))
    print(f"kept {src.name} {bits.shape} as {dst}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", type=int, choices=sorted(PHASES))
    ap.add_argument("--keep", action="append", default=[])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from xmipp3_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    _cuda_build.build()
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    cs.warm_ranks()
    root = ROOT / "chip_smoke_data" / f"p{args.phase}"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        kernels = PHASES[args.phase](root)
    except cs.SmokeFailure as e:
        print(f"phase {args.phase} FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        print(f"phase {args.phase} call {time.perf_counter() - t0:.2f} s",
              flush=True)
        out = ROOT / "chiprun_out"
        for name in args.keep:
            if (root / name).is_file():
                out.mkdir(exist_ok=True)
                keep(root / name, out / f"p{args.phase}_{Path(name).stem}")
        shutil.rmtree(root, ignore_errors=True)
    if kernels:
        print(json.dumps({"kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
