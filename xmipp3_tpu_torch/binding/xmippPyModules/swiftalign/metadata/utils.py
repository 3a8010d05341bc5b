from __future__ import annotations

import pandas as pd


def sort_by_image_filename(df: pd.DataFrame,
                           label: str = "image") -> pd.DataFrame:
    """Stable sort by the stack filename part of 'NNNNNN@file' references
    (keeps slices of the same stack contiguous for sequential IO)."""
    key = df[label].map(lambda s: str(s).rsplit("@", 1)[-1])
    return df.loc[key.sort_values(kind="stable").index].reset_index(
        drop=True)
