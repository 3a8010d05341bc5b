"""Judges, one module a job kind (`<kind>.py`): `numbers(job, data, cfg,
mix, seed, dev)` runs the plain reference over what the window produced
and returns each number compared, by name."""
