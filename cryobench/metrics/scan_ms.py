"""Milliseconds of the matching scan per batch: the program's own
synchronised `scan` phase (ops/match.py), its mean over the traced
window's batches."""
LAYER = "Matching scan (ops/match.py::_scan_trials, ops/polar.py)"
UNIT, SOURCE, MOVES = "ms", "program_span", "assign_rate"


def read(ctx):
    tot, n = ctx.phases.get("scan", (0.0, 0))
    return tot / n * 1e3 if n else None
