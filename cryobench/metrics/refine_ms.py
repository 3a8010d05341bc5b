"""Milliseconds of the winners' refinement per batch: the program's own
synchronised `refine` phase (ops/match.py), its mean over the traced
window's batches."""
LAYER = ("Matching refinement (ops/match.py::refine_winners, "
         "ops/shear_rotate.py, ops/shift.py)")
UNIT, SOURCE, MOVES = "ms", "program_span", "assign_rate"


def read(ctx):
    tot, n = ctx.phases.get("refine", (0.0, 0))
    return tot / n * 1e3 if n else None
