"""Probe the card-side choices of the movie and MonoRes slice on one CUDA
card, and print each reading with the card's name and power limit:

1. the port's global positions of phantom_movie -size 4096 4096 40 --seed
   0 on the card and on the CPU: their largest difference and each one's
   median and worst error against the _gt.xmd truth (gauge: mean 0);
2. the order statistic MonoRes and the percentiles take: torch.kthvalue
   against torch.sort on (12, 12.5M), (1, 12.5M) and a 1-D 12.5M tensor
   (12.5M is the noise region outside a radius-100 sphere in 256^3);
3. monogenic_amplitude_3d of twelve 256^3 band images with its Riesz
   kernels made once per shape and card, and with them made on the host
   and uploaded in every call; and the profiler's kernels of one call.

Times are CUDA-event means after a warm-up. Run from the repo root on a
machine with a card:

    python3 tools/probe_movie_monores.py
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def cuda_ms(fn, reps: int = 3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_movie_monores: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.ops import monogenic as mono
    from xmipp3_tpu_torch.ops import movie as tm
    from xmipp3_tpu_torch.programs import get_program
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        fn = str(Path(tmp) / "m.mrcs")
        assert get_program("phantom_movie").run_with_args(
            ["-o", fn, "-size", "4096", "4096", "40", "--seed", "0",
             "-v", "0"]) == 0
        md = MetaData(fn[:-5] + "_gt.xmd")
        truth = np.stack([md.getColumn("shiftX"), md.getColumn("shiftY")],
                         1)
        frames = Image.read_stack(fn)
    pos = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pos[dev] = tm.global_align(frames, 50, device=dev)
        med, worst = cs.position_errors(pos[dev], truth)
        print(f"global positions on {dev}: {time.perf_counter() - t0:.3f} s,"
              f" median {med:.4f} px, worst {worst:.4f} px", flush=True)
    print(f"card vs CPU: {np.abs(pos['cuda'] - pos['cpu']).max():.3e} px",
          flush=True)
    del frames

    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((12, 12_500_000), (1, 12_500_000), (12_500_000,)):
        x = torch.randn(shape, device="cuda", generator=g)
        k = int(0.95 * (shape[-1] - 1))
        kth = cuda_ms(lambda: torch.kthvalue(x, k + 1, dim=-1))
        srt = cuda_ms(lambda: torch.sort(x, dim=-1))
        print(f"order statistic of {shape}: kthvalue {kth:.3f} ms, sort "
              f"{srt:.3f} ms", flush=True)
    del x

    vol = torch.randn((12, 256, 256, 256), device="cuda", generator=g)

    def uploaded_each_call():
        kx, ky, kz = (torch.as_tensor(k, device="cuda")
                      for k in mono._riesz_kernels(256, 256, 256))
        F = torch.fft.rfftn(vol, dim=(-3, -2, -1))
        rx, ry, rz = torch.fft.irfftn(
            torch.stack([1j * kx * F, 1j * ky * F, 1j * kz * F]),
            s=(256,) * 3, dim=(-3, -2, -1))
        return torch.sqrt(vol * vol + rx * rx + ry * ry + rz * rz)

    cached = cuda_ms(lambda: mono.monogenic_amplitude_3d(vol))
    upload = cuda_ms(uploaded_each_call)
    t0 = time.perf_counter()
    uploaded_each_call()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    print(f"amplitude of 12 x 256^3: {cached:.3f} ms with the kernels made "
          f"once, {upload:.3f} ms (card) / {host * 1e3:.1f} ms (host clock) "
          "with them made and uploaded per call", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mono.monogenic_amplitude_3d(vol)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8,
                                    max_name_column_width=50))
    return 0


if __name__ == "__main__":
    sys.exit(main())
