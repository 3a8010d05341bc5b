"""'NNNNNN@stack' image path handling (reference swiftalign/image/Path.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Path:
    filename: str
    position_in_stack: Optional[int] = None

    def __str__(self) -> str:
        if self.position_in_stack is None:
            return self.filename
        return f"{self.position_in_stack:06d}@{self.filename}"


def parse_path(s) -> Path:
    s = str(s)
    if "@" in s:
        idx, fn = s.split("@", 1)
        return Path(fn, int(idx))
    return Path(s)
