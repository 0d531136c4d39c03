"""Data pipeline types: DataInst / DataBatch / IIterator (counterpart of
``cxxnet_tpu/io/data.py``).

A two-level iterator pattern: instance iterators (one example at a
time) composed into batch iterators by adapters, configured by ordered
``iter = type ... iter = end`` blocks with chaining.

Batches are host NumPy arrays with static shapes: every batch is full
size and ``num_batch_padd`` marks trailing padding rows that loss,
metrics and predictions ignore. ``data`` is NHWC (batch, y, x, ch) for
spatial inputs or (batch, features) for flat inputs, while configs
describe shapes as (ch, y, x).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils.config import NotPortedError, Roadmap


@dataclass
class DataInst:
    """A single training instance."""
    index: int
    data: np.ndarray                  # (y, x, ch) or (features,)
    label: np.ndarray                 # (label_width,)
    extra_data: List[np.ndarray] = field(default_factory=list)


@dataclass
class DataBatch:
    """A batch of instances: ``data`` is (batch, y, x, ch) or (batch,
    features), ``label`` (batch, label_width); the last
    ``num_batch_padd`` rows are padding.

    ``release`` is the host-buffer ownership hand-off: when the batch's
    arrays live in a preallocated ring buffer (BatchAdapter's zero-copy
    assembly), calling it returns the buffer for reuse. Only call it
    once nothing will read the arrays again. None means the arrays are
    ordinary garbage-collected allocations.
    """
    data: np.ndarray
    label: Optional[np.ndarray] = None
    inst_index: Optional[np.ndarray] = None
    num_batch_padd: int = 0
    extra_data: List[np.ndarray] = field(default_factory=list)
    release: Optional[Callable[[], None]] = None

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


class IIterator:
    """Iterator interface: init / before_first / next / value, plus
    set_param for config plumbing."""

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    def value(self):
        raise NotImplementedError

    def close(self) -> None:
        """Release background resources (threads, pools). Adapters
        forward to their base; safe to call more than once."""
        base = getattr(self, "base", None)
        if base is not None:
            base.close()

    def __iter__(self):
        self.before_first()
        while self.next():
            yield self.value()


def shape_from_conf(val: str) -> Tuple[int, int, int]:
    """Parse 'z,y,x' input_shape (ch, y, x)."""
    z, y, x = (int(t) for t in val.split(","))
    return (z, y, x)


def inst_array_shape(shape3: Tuple[int, int, int]) -> Tuple[int, ...]:
    """Per-instance array shape of a logical (ch, y, x) input shape."""
    ch, y, x = shape3
    if ch == 1 and y == 1:
        return (x,)
    return (y, x, ch)


def resolve_data_shard(part_index: int, num_parts: int):
    """The (part_index, num_parts) data shard of this process.

    Only the config keys decide it. An initialized ``torch.distributed``
    world larger than 1 without them raises: reading shard 0 on every
    rank would silently duplicate data, and the multi-GPU item ports
    the rank autodetect."""
    if num_parts > 1:
        return part_index, num_parts
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotPortedError(
            "reading data in a torch.distributed world of %d processes "
            "without part_index/num_parts" % dist.get_world_size(),
            Roadmap.MULTI_GPU)
    return 0, 1


def batch_mask(batch: DataBatch) -> Optional[np.ndarray]:
    """Row-validity mask of a batch: float32 1.0 for real rows and 0.0
    for the padded tail, or None when every row is real (the
    steady-state case, where batch norm and the loss skip the mask)."""
    if not batch.num_batch_padd:
        return None
    m = np.ones((batch.batch_size,), np.float32)
    m[batch.batch_size - batch.num_batch_padd:] = 0.0
    return m
