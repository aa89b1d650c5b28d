# Small LRU cache used by the recorder and audio framing elements.
# (capability parity: aiko_services/utilities/lru_cache.py:22-47)
#
# The port's own copy of aiko_services_tpu/utils/lru_cache.py.

from __future__ import annotations

from collections import OrderedDict

__all__ = ["LRUCache"]


class LRUCache:
    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("LRUCache size must be positive")
        self.size = size
        self._data: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        if key in self._data:
            self._data.move_to_end(key)
            return self._data[key]
        return default

    def put(self, key, value):
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.size:
            self._data.popitem(last=False)

    def delete(self, key):
        self._data.pop(key, None)

    def keys(self):
        return list(self._data.keys())

    def values(self):
        return list(self._data.values())

    def items(self):
        return list(self._data.items())

    def __contains__(self, key):
        return key in self._data

    def __len__(self):
        return len(self._data)
