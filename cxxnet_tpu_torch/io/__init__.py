"""Data records (the iterators are not ported yet)."""

from .data import DataBatch, inst_array_shape

__all__ = ["DataBatch", "inst_array_shape"]
