"""The batch record and instance shapes (counterpart of the parts of
``cxxnet_tpu/io/data.py`` that prediction uses). The iterators come
with the CLI slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class DataBatch:
    """A batch of instances: ``data`` is (batch, y, x, ch) or (batch,
    features); the last ``num_batch_padd`` rows are padding."""
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
