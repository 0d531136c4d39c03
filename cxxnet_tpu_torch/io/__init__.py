"""Data records (the iterators are not ported yet)."""

from .data import DataBatch, batch_mask, inst_array_shape

__all__ = ["DataBatch", "batch_mask", "inst_array_shape"]
