"""Share of the traced window in which no operation ran on the card, in a
match cell."""
LAYER = "Device"
UNIT, SOURCE, MOVES = "%", "device_trace", "rec_rate"


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
