"""Device milliseconds a batch spends building the gridding's sample
streams: the program's spans `grid.ctf` (the (C, S) CTF table, once a
batch), `grid.spectra` (rfft2, shift phases, the disk's samples, weights
and CTF factors) and `grid.coords` (the tap coordinates, the streams made
flat), once a symmetry copy, timed on the card's stream, over the traced
window's batches (one `grid` a batch)."""
LAYER = ("Gridding (ops/reconstruct.py::add_batch, backproject_chunk, "
         "ops/ctf.py)")
UNIT, SOURCE, MOVES = "ms", "program_span", "rec_rate"
PARTS = ("grid.ctf", "grid.spectra", "grid.coords")


def read(ctx):
    grid = ctx.phases.get("device:grid")
    if not grid or "device:grid.spectra" not in ctx.phases:
        return None
    total = sum(ctx.phases.get("device:" + p, (0.0, 0))[0] for p in PARTS)
    return total / grid[1] * 1e3
