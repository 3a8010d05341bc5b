from __future__ import annotations

from collections import OrderedDict


class LruCache:
    """Small LRU cache (reference swiftalign/utils/LruCache.py role:
    caching image stacks during streaming alignment)."""

    def __init__(self, capacity: int = 16):
        self.capacity = int(capacity)
        self._d = OrderedDict()

    def get(self, key, default=None):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return default

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __contains__(self, key):
        return key in self._d

    def __len__(self):
        return len(self._d)
