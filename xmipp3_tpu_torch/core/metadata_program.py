"""Batch loading of the images that metadata rows name.

The part of the reference package's core/metadata_program.py that the
ported programs use: `load_image_rows` reads the 'image' column of a chunk
of rows, and `BatchPrefetcher` reads the next chunk on a host thread while
the card works on the current one. The loader thread touches numpy only.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from xmipp3_tpu_torch.core.filename import as_filename
from xmipp3_tpu_torch.core.image import Image


def load_image_rows(rows: list[dict]) -> np.ndarray:
    """Batch-load the 'image' column of metadata rows as (n, Y, X) float32.

    Consecutive rows that name slices of one stack go through
    Image.read_slices in one call (one open, one read per run of
    consecutive slices): the data-loader hot path for big particle sets."""
    n = len(rows)
    out: list = [None] * n
    i = 0
    while i < n:
        fn = as_filename(rows[i]["image"])
        if fn.slice_index is None:
            out[i] = np.squeeze(Image(rows[i]["image"]).data)
            i += 1
            continue
        j = i
        idxs = []
        while j < n:
            fj = as_filename(rows[j]["image"])
            if fj.path != fn.path or fj.slice_index is None:
                break
            idxs.append(fj.slice_index - 1)
            j += 1
        out[i:j] = Image.read_slices(fn.path, idxs)
        i = j
    return np.stack(out).astype(np.float32)


class BatchPrefetcher:
    """Double-buffered batch loader: loads batch i+1 on a host thread while
    the device computes on batch i. Iterating yields (start, rows, images)
    per batch; an error in the loader is raised in the consumer."""

    def __init__(self, rows: list[dict], batch_size: int, loader=None,
                 depth: int = 2):
        self._rows = rows
        self._bs = batch_size
        self._loader = loader or load_image_rows
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._t = threading.Thread(target=self._produce, daemon=True)
        self._t.start()

    def _produce(self):
        try:
            for s in range(0, len(self._rows), self._bs):
                chunk = self._rows[s:s + self._bs]
                self._q.put((s, chunk, self._loader(chunk)))
        except Exception as e:
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item
