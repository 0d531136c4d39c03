"""Sparse instances and the libsvm iterator (counterpart of
``cxxnet_tpu/io/iter_libsvm.py``).

Format: libsvm / svmlight text, ``label[,label2,...] idx:val idx:val
...`` a line (``#`` starts a comment), 0- or 1-based indices
(``index_base``); the feature width comes from ``input_shape``
(``1,1,D``). The dataset is kept CSR-style on the host (``csr()``,
``sparse_inst``) and each instance is densified as it is emitted.
Rows shard by stride over ``part_index`` / ``num_parts``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from .data import (DataInst, IIterator, inst_array_shape,
                   resolve_data_shard, shape_from_conf)
from ..utils.stream import open_stream


class SparseInst(NamedTuple):
    """One sparse instance: its labels and (index, value) entries."""
    index: int
    label: np.ndarray
    findex: np.ndarray          # feature indices (uint32)
    fvalue: np.ndarray          # feature values (float32)

    def dense(self, width: int) -> np.ndarray:
        out = np.zeros((width,), np.float32)
        out[self.findex] = self.fvalue
        return out


class LibSVMIterator(IIterator):
    def __init__(self):
        self.filename = ""
        self.silent = 0
        self.label_width = 1
        self.index_base = 0
        self.shape = (0, 0, 0)
        self.part_index = 0
        self.num_parts = 1
        # CSR storage
        self.labels: Optional[np.ndarray] = None
        self.indptr: Optional[np.ndarray] = None
        self.findex: Optional[np.ndarray] = None
        self.fvalue: Optional[np.ndarray] = None
        self.row_ids: Optional[np.ndarray] = None
        self.idx = 0
        self.out: Optional[DataInst] = None

    def set_param(self, name: str, val: str) -> None:
        if name == "filename":
            self.filename = val
        if name == "silent":
            self.silent = int(val)
        if name == "label_width":
            self.label_width = int(val)
        if name == "index_base":
            self.index_base = int(val)
        if name == "input_shape":
            self.shape = shape_from_conf(val)
        if name == "part_index":
            self.part_index = int(val)
        if name == "num_parts":
            self.num_parts = int(val)

    @property
    def num_feat(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    def init(self) -> None:
        assert self.filename, "libsvm: filename must be set"
        assert self.num_feat > 0, "libsvm: input_shape must be set"
        labels: List[List[float]] = []
        indptr = [0]
        findex: List[int] = []
        fvalue: List[float] = []
        with open_stream(self.filename, "r") as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                toks = line.split()
                labels.append([float(t) for t in
                               toks[0].split(",")[:self.label_width]])
                for t in toks[1:]:
                    i, v = t.split(":")
                    fi = int(i) - self.index_base
                    if not 0 <= fi < self.num_feat:
                        raise ValueError(
                            "libsvm: feature index %s out of range "
                            "[0, %d) in %s" % (i, self.num_feat,
                                               self.filename))
                    findex.append(fi)
                    fvalue.append(float(v))
                indptr.append(len(findex))
        self.labels = np.asarray(labels, np.float32)
        self.indptr = np.asarray(indptr, np.int64)
        self.findex = np.asarray(findex, np.uint32)
        self.fvalue = np.asarray(fvalue, np.float32)
        n = self.labels.shape[0]
        pi, nparts = resolve_data_shard(self.part_index, self.num_parts)
        self.row_ids = np.arange(n)[pi::nparts]
        if self.silent == 0:
            print("LibSVMIterator: %d rows (%d local), %d nnz from %s"
                  % (n, len(self.row_ids), len(self.findex),
                     self.filename))
        self.idx = 0

    def sparse_inst(self, row: int) -> SparseInst:
        a, b = self.indptr[row], self.indptr[row + 1]
        return SparseInst(index=row, label=self.labels[row],
                          findex=self.findex[a:b],
                          fvalue=self.fvalue[a:b])

    def csr(self):
        """(labels, indptr, findex, fvalue) of the whole dataset."""
        return self.labels, self.indptr, self.findex, self.fvalue

    def before_first(self) -> None:
        self.idx = 0

    def next(self) -> bool:
        if self.row_ids is None or self.idx >= len(self.row_ids):
            return False
        row = int(self.row_ids[self.idx])
        inst = self.sparse_inst(row)
        data = inst.dense(self.num_feat)
        if len(inst_array_shape(self.shape)) != 1:
            ch, y, x = self.shape
            data = data.reshape(ch, y, x).transpose(1, 2, 0)
        self.out = DataInst(index=row, data=data, label=inst.label)
        self.idx += 1
        return True

    def value(self) -> DataInst:
        return self.out
