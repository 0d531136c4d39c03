"""MNIST idx-format batch iterator (counterpart of
``cxxnet_tpu/io/iter_mnist.py``): loads the whole idx archive into RAM,
normalizes by 1/256, optional whole-epoch shuffle, yields full batches
only (the tail that doesn't fill a batch is dropped), label width 1, ``input_flat`` selects (b, 784) vs (b, 28, 28, 1),
``index_offset`` seeds instance indices.

Also reads gzip files transparently (the download scripts keep .gz).
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional

import numpy as np

from .data import DataBatch, IIterator, resolve_data_shard


class _ClosingGzip(gzip.GzipFile):
    """GzipFile that also closes the externally supplied fileobj
    (GzipFile.close() deliberately leaves it open)."""

    def close(self):
        fo = self.fileobj
        try:
            super().close()
        finally:
            if fo is not None:
                fo.close()


def _open(path: str):
    from ..utils.stream import open_stream, stream_exists
    if path.endswith(".gz") or not stream_exists(path) and \
            stream_exists(path + ".gz"):
        gz = path if path.endswith(".gz") else path + ".gz"
        return _ClosingGzip(fileobj=open_stream(gz, "rb"))
    return open_stream(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">iiii", f.read(16))
        buf = f.read(n * rows * cols)
    return np.frombuffer(buf, np.uint8).reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">ii", f.read(8))
        buf = f.read(n)
    return np.frombuffer(buf, np.uint8)


class MNISTIterator(IIterator):
    kRandMagic = 0

    def __init__(self):
        self.silent = 0
        self.batch_size = 0
        self.input_flat = 1
        self.shuffle = 0
        self.inst_offset = 0
        self.path_img = ""
        self.path_label = ""
        self.seed = self.kRandMagic
        self.part_index = 0
        self.num_parts = 1
        self.loc = 0
        self.out: Optional[DataBatch] = None

    def set_param(self, name: str, val: str) -> None:
        if name == "silent":
            self.silent = int(val)
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "input_flat":
            self.input_flat = int(val)
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "index_offset":
            self.inst_offset = int(val)
        if name == "path_img":
            self.path_img = val
        if name == "path_label":
            self.path_label = val
        if name == "seed_data":
            self.seed = self.kRandMagic + int(val)
        if name == "part_index":
            self.part_index = int(val)
        if name == "num_parts":
            self.num_parts = int(val)

    def init(self) -> None:
        assert self.batch_size > 0, "mnist iterator: batch_size not set"
        img = read_idx_images(self.path_img).astype(np.float32) / 256.0
        lab = read_idx_labels(self.path_label).astype(np.float32)
        n = img.shape[0]
        inst = np.arange(n, dtype=np.uint32) + self.inst_offset
        if self.shuffle:
            rng = np.random.RandomState(self.seed)
            perm = rng.permutation(n)
            img, lab, inst = img[perm], lab[perm], inst[perm]
        # disjoint strided shard per distributed rank (after the
        # seed-deterministic shuffle so ranks agree on the permutation)
        pi, nparts = resolve_data_shard(self.part_index, self.num_parts)
        if nparts > 1:
            img, lab, inst = img[pi::nparts], lab[pi::nparts], \
                inst[pi::nparts]
            n = img.shape[0]
        if self.input_flat:
            self.img = img.reshape(n, -1)
        else:
            self.img = img[..., None]            # NHWC, ch=1
        self.labels = lab[:, None]
        self.inst = inst
        self.loc = 0
        if self.silent == 0:
            print("MNISTIterator: load %d images, shuffle=%d, shape=%s"
                  % (n, self.shuffle, (self.batch_size,) +
                     self.img.shape[1:]))

    def before_first(self) -> None:
        self.loc = 0

    def next(self) -> bool:
        b = self.batch_size
        if self.loc + b <= self.img.shape[0]:
            s = slice(self.loc, self.loc + b)
            self.out = DataBatch(data=self.img[s], label=self.labels[s],
                                 inst_index=self.inst[s])
            self.loc += b
            return True
        return False

    def value(self) -> DataBatch:
        return self.out
