"""Device milliseconds of gridding a batch: the program's span `grid`
(`FourierReconstructor.add_batch`, every symmetry copy) timed on the card's
stream, its mean over the traced window's batches."""
LAYER = ("Gridding (ops/reconstruct.py::add_batch, backproject_chunk, "
         "ops/ctf.py)")
UNIT, SOURCE, MOVES = "ms", "program_span", "rec_rate"


def read(ctx):
    grid = ctx.phases.get("device:grid")
    return grid[0] / grid[1] * 1e3 if grid else None
