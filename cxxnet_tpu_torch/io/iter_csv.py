"""CSV instance iterator (counterpart of ``cxxnet_tpu/io/iter_csv.py``).

Row format: label_width labels, then ch*y*x features, comma-separated.
Yields DataInst; compose with BatchAdapter for batches. Rows shard by
stride over ``part_index`` / ``num_parts``, or under ``shard_kind =
batch`` (``shard_global_batch``, ``shard_start_record``) by the
batch-block map of ``io/shard.py``, whose slices concatenated in rank
order give the unsharded order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .data import (DataInst, IIterator, inst_array_shape,
                   resolve_data_shard, shape_from_conf)
from ..utils.stream import open_stream


class CSVIterator(IIterator):
    def __init__(self):
        self.filename = ""
        self.has_header = 0
        self.silent = 0
        self.label_width = 1
        self.shape = (0, 0, 0)
        self.part_index = 0
        self.num_parts = 1
        self.shard_kind = "stride"
        self.shard_global_batch = 0
        self.shard_start_record = 0
        self.rows: Optional[np.ndarray] = None
        self.indices: Optional[np.ndarray] = None
        self.idx = 0
        self.out: Optional[DataInst] = None
        # batch-kind shard state: every row, and the index view of the
        # passes after the resumed one
        self._all_rows: Optional[np.ndarray] = None
        self._steady_idx: Optional[np.ndarray] = None
        self._pass_ended = False

    def set_param(self, name: str, val: str) -> None:
        if name == "filename":
            self.filename = val
        if name == "has_header":
            self.has_header = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "label_width":
            self.label_width = int(val)
        if name == "input_shape":
            self.shape = shape_from_conf(val)
        if name == "part_index":
            self.part_index = int(val)
        if name == "num_parts":
            self.num_parts = int(val)
        if name == "shard_kind":
            if val not in ("stride", "batch"):
                raise ValueError(
                    "shard_kind must be stride or batch, got %r" % val)
            self.shard_kind = val
        if name == "shard_global_batch":
            self.shard_global_batch = int(val)
        if name == "shard_start_record":
            self.shard_start_record = int(val)

    def init(self) -> None:
        skip = 1 if self.has_header else 0
        with open_stream(self.filename, "r") as f:
            self.rows = np.loadtxt(f, delimiter=",", skiprows=skip,
                                   dtype=np.float32, ndmin=2)
        nfeat = self.shape[0] * self.shape[1] * self.shape[2]
        if self.rows.shape[1] != self.label_width + nfeat:
            raise ValueError(
                "CSVIterator: row width %d != label_width %d + features %d"
                % (self.rows.shape[1], self.label_width, nfeat))
        if self.shard_kind == "batch":
            # this part's slice of every global batch; the
            # shard_start_record offset applies to the first pass only
            from .shard import plan_from_params
            assert self.shard_global_batch > 0, \
                "shard_kind=batch requires shard_global_batch"
            plan = plan_from_params(self.part_index, self.num_parts,
                                    self.shard_global_batch,
                                    self.shard_start_record)
            self._all_rows = self.rows
            n = self._all_rows.shape[0]
            self._steady_idx = np.asarray(
                plan.steady().owned_indices(n), np.int64)
            self.indices = np.asarray(plan.owned_indices(n), np.int64) \
                if plan.start_record else self._steady_idx
            self.rows = self._all_rows[self.indices]
        else:
            # disjoint strided shard per distributed rank
            pi, nparts = resolve_data_shard(self.part_index,
                                            self.num_parts)
            self.indices = np.arange(self.rows.shape[0])[pi::nparts]
            self.rows = self.rows[pi::nparts]
        if self.silent == 0:
            print("CSVIterator:filename=%s" % self.filename)
        self.idx = 0

    def before_first(self) -> None:
        # a reset after any consumption ends the resumed pass (later
        # epochs read the whole shard); resets before it keep the offset
        if (self._all_rows is not None
                and (self._pass_ended or self.idx > 0)
                and self.indices is not self._steady_idx):
            self.indices = self._steady_idx
            self.rows = self._all_rows[self.indices]
        self.idx = 0
        self._pass_ended = False

    def next(self) -> bool:
        if self.rows is None or self.idx >= self.rows.shape[0]:
            self._pass_ended = True
            return False
        row = self.rows[self.idx]
        label = row[:self.label_width]
        feats = row[self.label_width:]
        if len(inst_array_shape(self.shape)) == 1:
            data = feats
        else:
            ch, y, x = self.shape
            data = feats.reshape(ch, y, x).transpose(1, 2, 0)  # -> NHWC inst
        self.out = DataInst(index=int(self.indices[self.idx]),
                            data=data, label=label)
        self.idx += 1
        return True

    def value(self) -> DataInst:
        return self.out
