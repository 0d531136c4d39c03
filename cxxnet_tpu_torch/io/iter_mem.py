"""In-RAM batch cache, the ``membuffer`` adapter (counterpart of
``cxxnet_tpu/io/iter_mem.py``).

Caches the first ``max_nbatch`` batches of the underlying iterator on
first epoch and serves every later epoch from RAM.
"""

from __future__ import annotations

from typing import List, Optional

from .data import DataBatch, IIterator


class MemBufferIterator(IIterator):
    def __init__(self, base: IIterator):
        self.base = base
        self.max_nbatch = 0          # 0 = unlimited
        self.cache: List[DataBatch] = []
        self.filled = False
        self.idx = 0
        self._out: Optional[DataBatch] = None

    def set_param(self, name: str, val: str) -> None:
        self.base.set_param(name, val)
        if name == "max_nbatch":
            self.max_nbatch = int(val)

    def init(self) -> None:
        self.base.init()

    def before_first(self) -> None:
        self.idx = 0
        if not self.filled:
            self.base.before_first()

    def next(self) -> bool:
        if self.filled:
            if self.idx >= len(self.cache):
                return False
            self._out = self.cache[self.idx]
            self.idx += 1
            return True
        if (self.max_nbatch == 0 or len(self.cache) < self.max_nbatch) \
                and self.base.next():
            self._out = self.base.value()
            if self._out.release is not None:
                # the cache replays this batch every epoch: consume the
                # ring-buffer lease so nothing downstream can hand the
                # storage back for refill while it is cached
                self._out.release = None
            self.cache.append(self._out)
            return True
        self.filled = True
        return False

    def value(self) -> DataBatch:
        return self._out
