"""The batch record, the padded-tail mask it implies, and instance
shapes (counterpart of the parts of ``cxxnet_tpu/io/data.py`` that
prediction and training use). The iterators come with the CLI
slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class DataBatch:
    """A batch of instances: ``data`` is (batch, y, x, ch) or (batch,
    features), ``label`` (batch, label_width); the last
    ``num_batch_padd`` rows are padding."""
    data: np.ndarray
    label: Optional[np.ndarray] = None
    num_batch_padd: int = 0

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


def inst_array_shape(shape3: Tuple[int, int, int]) -> Tuple[int, ...]:
    """Per-instance array shape of a logical (ch, y, x) input shape."""
    ch, y, x = shape3
    if ch == 1 and y == 1:
        return (x,)
    return (y, x, ch)


def batch_mask(batch: DataBatch) -> Optional[np.ndarray]:
    """Row-validity mask of a batch: float32 1.0 for real rows and 0.0
    for the padded tail, or None when every row is real (the
    steady-state case, where batch norm and the loss skip the mask)."""
    if not batch.num_batch_padd:
        return None
    m = np.ones((batch.batch_size,), np.float32)
    m[batch.batch_size - batch.num_batch_padd:] = 0.0
    return m
