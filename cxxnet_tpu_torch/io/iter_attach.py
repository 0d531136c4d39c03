"""attachtxt: per-instance side data joined into ``batch.extra_data``
(counterpart of ``cxxnet_tpu/io/iter_attach.py``).

File format: the first token is the data width, then rows of
``<instance_id> <v1> ... <vdim>``. Each batch gets a ``(batch, dim)``
float32 matrix looked up by ``inst_index``, the net's extra input node
``in_1`` (``extra_data_num = 1``, ``extra_data_shape[0] = 1,1,<dim>``).
Instances missing from the file get zeros.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .data import DataBatch, IIterator
from ..utils.stream import open_stream


class AttachTxtIterator(IIterator):
    """Batch-level adapter over a batch iterator."""

    def __init__(self, base: IIterator):
        self.base = base
        self.filename = ""
        self.dim = 0
        self._rows: Dict[int, np.ndarray] = {}
        self._out: DataBatch = None

    def set_param(self, name: str, val: str) -> None:
        # 'filename' after the attachtxt line names the side-data file
        # and stops here; every other key goes down the chain
        if name == "filename":
            self.filename = val
            return
        self.base.set_param(name, val)

    def init(self) -> None:
        self.base.init()
        assert self.filename, "attachtxt: filename must be set"
        with open_stream(self.filename, "r") as f:
            tokens = f.read().split()
        assert tokens, "attachtxt: empty file %s" % self.filename
        self.dim = int(tokens[0])
        assert self.dim > 0, "attachtxt: dim must be positive"
        assert (len(tokens) - 1) % (self.dim + 1) == 0, \
            "attachtxt: data do not match dimension specified"
        for pos in range(1, len(tokens), self.dim + 1):
            self._rows[int(tokens[pos])] = np.asarray(
                [float(t) for t in tokens[pos + 1:pos + 1 + self.dim]],
                np.float32)

    def before_first(self) -> None:
        self.base.before_first()

    def next(self) -> bool:
        if not self.base.next():
            return False
        b = self.base.value()
        extra = np.zeros((b.batch_size, self.dim), np.float32)
        if b.inst_index is not None:
            for i, idx in enumerate(np.asarray(b.inst_index)):
                row = self._rows.get(int(idx))
                if row is not None:
                    extra[i] = row
        # the same storage: the ring lease travels with the rewrap
        self._out = DataBatch(data=b.data, label=b.label,
                              inst_index=b.inst_index,
                              num_batch_padd=b.num_batch_padd,
                              extra_data=[extra], release=b.release)
        return True

    def value(self) -> DataBatch:
        return self._out
