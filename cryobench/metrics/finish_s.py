"""Seconds of a job's finalize: the benchmark's synchronised span around
`FourierReconstructor.finish`, its mean over the traced window's jobs."""
LAYER = "Finalize (ops/reconstruct.py::finalize_volume)"
UNIT, SOURCE, MOVES = "s", "host_clock", "rec_rate"


def read(ctx):
    s = ctx.spans.get("finish")
    return sum(s) / len(s) if s else None
