"""The serve weight budget's typed error (counterpart of the part of
``cxxnet_tpu/artifact/registry.py`` the port has: the rest of that
module, the program registry of sealed bundles, comes with them)."""

from __future__ import annotations


class ResidencyBudgetError(RuntimeError):
    """Loading (or hot-swapping in) a model would exceed the explicit
    ``serve_device_mem_budget`` — the memory-honest alternative to
    discovering the overcommit as a device OOM mid-request. The load
    is rejected whole; whatever was serving keeps serving."""
