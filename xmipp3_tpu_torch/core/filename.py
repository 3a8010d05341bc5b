"""FileName semantics: compound path addressing, as in xmippCore's FileName.

Contract (usage observed throughout the reference, e.g.
reconstruction/reconstruct_fourier.cpp:199 `I.read(fnImg, HEADER)` with names
like "000001@particles.stk"):
  "<n>@stack.mrcs"   — 1-based slice n of an image stack
  "<block>@file.xmd" — metadata block inside a STAR file
  "file.mrc:mrcs"    — force-read with a given format codec
  "file.raw#10,10,0,float" — raw with inline geometry (rare; supported minimally)
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass


@dataclass(frozen=True)
class FileName:
    raw: str

    def __str__(self) -> str:
        return self.raw

    # --- decomposition -------------------------------------------------
    @property
    def prefix(self) -> str:
        """Part before '@' (slice number or block name), or ''. """
        return self.raw.split("@", 1)[0] if "@" in self.raw else ""

    @property
    def path(self) -> str:
        """Filesystem path: strips '<x>@' prefix and ':fmt' suffix."""
        p = self.raw.split("@", 1)[1] if "@" in self.raw else self.raw
        # ':fmt' suffix (not a windows drive; xmipp formats are alpha suffixes)
        m = re.match(r"^(.*):([a-zA-Z0-9]+)$", p)
        if m and not os.path.exists(p):
            return m.group(1)
        return p

    @property
    def forced_format(self) -> str | None:
        p = self.raw.split("@", 1)[1] if "@" in self.raw else self.raw
        m = re.match(r"^(.*):([a-zA-Z0-9]+)$", p)
        if m and not os.path.exists(p):
            return m.group(2).lower()
        return None

    @property
    def slice_index(self) -> int | None:
        """1-based stack slice if the prefix (or its 'n,block' first half)
        is numeric, else None."""
        pre = self.prefix.split(",", 1)[0]
        return int(pre) if pre.isdigit() else None

    @property
    def block(self) -> str | None:
        """Metadata block name if present, else None. Handles the compound
        'n,block@file' form (reference FileName::getBlockName,
        test_filename_main.cpp:24-44: '1@f' has NO block, 'a@f' -> 'a',
        '1,a@f' -> 'a', '1,@f' -> none)."""
        pre = self.prefix
        if "," in pre:
            pre = pre.split(",", 1)[1]
        return pre if pre and not pre.isdigit() else None

    def get_block_name(self) -> str:
        """Reference FileName::getBlockName: block name or ''. """
        return self.block or ""

    def remove_block_name(self) -> "FileName":
        """Reference FileName::removeBlockName (test_filename_main.cpp:47-65):
        strips the block part of the prefix, keeping a numeric slice —
        'a@f' -> 'f', '1,a@f' -> '1@f', '1,@f' -> '1@f', '@f' -> 'f',
        '1@f' and 'f' unchanged."""
        if "@" not in self.raw:
            return self
        pre, rest = self.raw.split("@", 1)
        if "," in pre:
            head = pre.split(",", 1)[0]
            return FileName(f"{head}@{rest}")
        if pre == "" or (pre and not pre.isdigit()):
            return FileName(rest)
        return self

    def is_empty(self) -> bool:
        return self.raw == ""

    @property
    def ext(self) -> str:
        return os.path.splitext(self.path)[1].lstrip(".").lower()

    def exists(self) -> bool:
        return os.path.exists(self.path)

    # --- composition ---------------------------------------------------
    @staticmethod
    def compose(prefix, path: str) -> "FileName":
        if isinstance(prefix, int):
            return FileName(f"{prefix:06d}@{path}")
        return FileName(f"{prefix}@{path}")

    def with_suffix(self, suffix: str) -> "FileName":
        base, ext = os.path.splitext(self.path)
        return FileName(base + suffix + ext)


def as_filename(fn) -> FileName:
    return fn if isinstance(fn, FileName) else FileName(str(fn))
