"""Milliseconds of gridding per batch: the benchmark's synchronised span
around `FourierReconstructor.add_batch`, its mean over the traced window's
batches."""
LAYER = ("Gridding (ops/reconstruct.py::add_batch, backproject_chunk, "
         "ops/ctf.py)")
UNIT, SOURCE, MOVES = "ms", "host_clock", "rec_rate"


def read(ctx):
    s = ctx.spans.get("add_batch")
    return sum(s) / len(s) * 1e3 if s else None
