"""Device seconds of a job's finalize: the program's span `finalize`
(`finalize_volume`: Hermitian mirrors, D/W, the inverse 3-D FFT, the crop)
timed on the card's stream, its mean over the traced window's jobs."""
LAYER = "Finalize (ops/reconstruct.py::finalize_volume)"
UNIT, SOURCE, MOVES = "s", "program_span", "rec_rate"


def read(ctx):
    fin = ctx.phases.get("device:finalize")
    return fin[0] / fin[1] if fin else None
