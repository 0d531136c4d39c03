"""Reader and writer for the legacy BinaryPage (imgbin) format
(counterpart of ``cxxnet_tpu/io/binpage.py``).

Fixed 64 MiB pages of int32 words: word 0 is the object count, words
1..n+1 the cumulative byte sizes, and the object bytes are packed
backward from the page end. Archives written here and by the reference
are byte-identical.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from ..utils.stream import open_stream

KPAGE_WORDS = 64 << 18
KPAGE_BYTES = KPAGE_WORDS * 4


def read_pages(path: str) -> Iterator[List[bytes]]:
    """Yield the list of objects of each page; a trailing partial page
    raises."""
    with open_stream(path, "rb") as f:
        while True:
            raw = f.read(KPAGE_BYTES)
            if not raw:
                return
            if len(raw) < KPAGE_BYTES:
                raise IOError(
                    "truncated BinaryPage archive %r: trailing partial "
                    "page of %d bytes" % (path, len(raw)))
            words = np.frombuffer(raw, "<i4")
            n = int(words[0])
            cum = words[1:n + 2].astype(np.int64)
            yield [raw[KPAGE_BYTES - int(cum[r + 1]):
                       KPAGE_BYTES - int(cum[r])] for r in range(n)]


def iter_objects(path: str) -> Iterator[bytes]:
    for objs in read_pages(path):
        yield from objs


class PageWriter:
    """Appends objects to pages, writing each page when the next object
    does not fit."""

    def __init__(self, path: str):
        self._f = open_stream(path, "wb")
        self._objs: List[bytes] = []
        self._used = 0                   # payload bytes in this page

    def _free(self) -> int:
        return (KPAGE_WORDS - (len(self._objs) + 2)) * 4 - self._used

    def write(self, data: bytes) -> None:
        if len(data) + 4 > self._free():
            self._flush()
            if len(data) + 4 > self._free():
                raise ValueError("object too large for one page")
        self._objs.append(data)
        self._used += len(data)

    def _flush(self) -> None:
        if not self._objs:
            return
        arr = bytearray(KPAGE_BYTES)
        arr[0:4] = np.int32(len(self._objs)).tobytes()
        cum = 0
        for r, o in enumerate(self._objs):
            cum += len(o)
            arr[(r + 2) * 4:(r + 3) * 4] = np.int32(cum).tobytes()
            arr[KPAGE_BYTES - cum:KPAGE_BYTES - cum + len(o)] = o
        self._f.write(arr)
        self._objs, self._used = [], 0

    def close(self) -> None:
        self._flush()
        self._f.close()
