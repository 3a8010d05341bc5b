"""Readings that set a cell's limits: the program's numbers and its
control's, over many seeds in one process.

    python3 cryobench/control.py --workload <name> --seeds <n> [<n> ...] \
        [--control-seeds <k>] [--out <file>]

For each seed: the cell's inputs, a short window at the cell's own load
(one whole job for a reconstruct cell, two batches for a match cell, as
many as a run's check reads), then the numbers the check compares for the
program, and, on the first `--control-seeds` seeds, for the control: the
plain reference in the program's place, computed in the precision below
the configuration's (TF32 where it states float32 with TF32 off, bfloat16
where it states float32 alone). One JSON line a seed; the benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def control_precision(cfg: dict, kind: str) -> str:
    stated = cfg["precision"][kind]
    return "tf32" if "TF32 off" in stated else "bf16"


def readings(workload: str, seeds, control_seeds: int, root: Path,
             device: str = "cuda", emit=print):
    import torch
    from cryobench import data as data_mod
    from cryobench.jobs import load
    from cryobench.run import Spans, load_cell
    cell = load_cell(root, workload)
    kind = cell.mix["job"]
    judge = importlib.import_module(f"cryobench.judges.{kind}")
    prec = control_precision(cell.cfg, kind)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        data = data_mod.make(cell.cfg, seed, dev)
        job = load(kind).Job(cell.cfg, cell.mix, data, dev,
                             Spans(False, dev), seed)
        if i == 0:
            job.warm()
        steps = 0
        while True:
            st = job.step()
            steps += 1
            if (kind == "match" and steps >= 2) or st.job_end:
                break
        job.release()
        with torch.no_grad():
            row = {"seed": seed, "program": judge.numbers(
                job, data, cell.cfg, cell.mix, seed, dev)}
            if i < control_seeds:
                row["control"] = judge.numbers(job, data, cell.cfg,
                                               cell.mix, seed, dev,
                                               control=prec)
                row["control_precision"] = prec
        row["seconds"] = time.perf_counter() - t0
        emit(json.dumps(row))
        out.append(row)
        del job, data
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = Path.cwd()
    for p in (str(root), str(HERE.parent)):
        if p not in sys.path:
            sys.path.insert(0, p)
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    readings(args.workload, args.seeds, args.control_seeds, root,
             emit=emit)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
