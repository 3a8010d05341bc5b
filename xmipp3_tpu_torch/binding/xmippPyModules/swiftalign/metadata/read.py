"""STAR/xmd -> pandas DataFrame (reference swiftalign/metadata/read.py
contract: read(path, table=None) returns the named or first table)."""
from __future__ import annotations

from typing import Optional

import pandas as pd


def read(path: str, table: Optional[str] = None) -> pd.DataFrame:
    from xmipp3_tpu_torch.core.star import read_star
    blocks = read_star(str(path))
    if not blocks:
        return pd.DataFrame()
    if table is not None:
        for b in blocks:
            if b.name == table:
                return b.df.copy()
        raise KeyError(f"table {table!r} not in {path}")
    return blocks[0].df.copy()
