"""Seconds a job spends projecting its gallery (FourierProjector and the
slices): the benchmark's synchronised span around the gallery build, the
mean over the traced window's jobs."""
LAYER = "Gallery projection (ops/project.py, core/sampling.py)"
UNIT, SOURCE, MOVES = "s", "host_clock", "assign_rate"


def read(ctx):
    s = ctx.spans.get("gallery")
    return sum(s) / len(s) if s else None
