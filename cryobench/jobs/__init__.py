"""Window runners, one module a job kind (`<kind>.py`), found by the
`job` key of a traffic mix. A module defines `Job(cfg, mix, data, dev,
spans, seed)` with `warm()` (set-up: every shape a job uses, once) and
`step()` (one batch, returning a `Step`), and `KIND`, its name."""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass
class Step:
    particles: int        # particles the batch completed
    job_end: bool         # the batch ended a job


def load(kind: str):
    """The runner module of job kind `kind`."""
    return importlib.import_module(f"cryobench.jobs.{kind}")
