"""Artifacts of a served model (counterpart of ``cxxnet_tpu/artifact/``).

What is ported: :class:`~.registry.ResidencyBudgetError`, the typed
rejection of ``serve_device_mem_budget``, and the runtime fingerprint
(:mod:`.fingerprint`) the fleet's ``/v1/models`` reports. Sealed bundles
(the reference's ``bundle.py`` and the rest of ``registry.py``) are not
ported yet: ROADMAP queue 1, sealed bundles.
"""

from .fingerprint import fingerprint_sha, runtime_fingerprint
from .registry import ResidencyBudgetError

__all__ = ["ResidencyBudgetError", "fingerprint_sha",
           "runtime_fingerprint"]
