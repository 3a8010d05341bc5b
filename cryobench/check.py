"""`correct`: the plain reference judges what the window produced, each
number against its limit in cryobench/limits/<workload>.json (a number
without a limit fails)."""
from __future__ import annotations

import importlib


def judge(cell, job, data, seed: int, dev) -> tuple[dict, int]:
    """({name: {"value": v, "limit": l}} of every number the cell's job
    kind compares, the particles whose outputs are not finite); runs after
    the window, with the program's state freed."""
    import torch
    mod = importlib.import_module(f"cryobench.judges.{cell.mix['job']}")
    job.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        got = mod.numbers(job, data, cell.cfg, cell.mix, seed, dev)
    out = {}
    for name, value in got.items():
        limit = cell.limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
    return out, mod.failed(job)


def passed(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
