from __future__ import annotations

import sys


def progress_bar(iterable, total=None, width: int = 40, stream=sys.stderr):
    """Minimal terminal progress bar over an iterable."""
    items = list(iterable) if total is None else iterable
    n = total if total is not None else len(items)
    for i, item in enumerate(items):
        if n:
            filled = int(width * (i + 1) / n)
            stream.write("\r[" + "#" * filled + "-" * (width - filled)
                         + f"] {i + 1}/{n}")
            stream.flush()
        yield item
    stream.write("\n")
