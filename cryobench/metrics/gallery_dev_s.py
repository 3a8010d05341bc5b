"""Device seconds a job spends projecting its gallery: the program's spans
`project.volume` (the map padded and its 3-D FFT) and `project.slices`
(central slices, shifts, batched irfft2), timed on the card's stream and
summed over the traced window, over the window's jobs (one
`project.volume` a job)."""
LAYER = "Gallery projection (ops/project.py, core/sampling.py)"
UNIT, SOURCE, MOVES = "s", "program_span", "assign_rate"


def read(ctx):
    vol = ctx.phases.get("device:project.volume")
    slices = ctx.phases.get("device:project.slices")
    if not vol or not slices:
        return None
    return (vol[0] + slices[0]) / vol[1]
