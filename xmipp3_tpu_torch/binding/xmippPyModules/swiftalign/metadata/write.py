"""pandas DataFrame -> STAR/xmd (reference swiftalign/metadata/write.py)."""
from __future__ import annotations

import pandas as pd


def write(df: pd.DataFrame, path: str, table: str = "noname") -> None:
    from xmipp3_tpu_torch.core.star import StarBlock, write_star
    write_star(str(path), [StarBlock(table, df.copy(), False)])
