"""Device milliseconds a batch spends on the scan's peaks: the program's
span `match.peaks` (the angular inverse rFFT of each trial's cross-spectra,
the argmax and the parabola, once straight and once mirrored), timed on the
card's stream, over the window's batches (one `scan` phase a batch)."""
LAYER = "Matching scan (ops/match.py::_scan_trials, ops/polar.py)"
UNIT, SOURCE, MOVES = "ms", "program_span", "assign_rate"


def read(ctx):
    peaks = ctx.phases.get("device:match.peaks")
    scan = ctx.phases.get("scan")
    if not peaks or not scan:
        return None
    return peaks[0] / scan[1] * 1e3
