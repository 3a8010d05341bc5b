"""Host milliseconds of gridding a batch: the program's span `grid`
(`FourierReconstructor.add_batch`) on the host's clock, not synchronised at
its end, so the time the host takes to enqueue a batch's work and to wait
where the program waits; near `grid_dev_ms`, the host paces gridding. Its
mean over the traced window's batches."""
LAYER = ("Gridding (ops/reconstruct.py::add_batch, backproject_chunk, "
         "ops/ctf.py)")
UNIT, SOURCE, MOVES = "ms", "program_span", "rec_rate"


def read(ctx):
    grid = ctx.phases.get("grid")
    return grid[0] / grid[1] * 1e3 if grid else None
