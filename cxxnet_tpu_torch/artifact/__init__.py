"""Artifacts of a served model (counterpart of ``cxxnet_tpu/artifact/``).

- :mod:`.registry` — :class:`ProgramStore`, the kernel libraries a
  trainer's serve path loaded and the hit / rebuild accounting of a
  bundle boot; :func:`parse_key`; :class:`ResidencyBudgetError`, the
  typed rejection of ``serve_device_mem_budget``.
- :mod:`.bundle` — the sealed on-disk artifact in the reference's
  format: ``task = export`` writes one; ``pred``, ``serve``,
  ``serve_fleet``, ``finetune`` and the hot-swap watcher boot from one.
  Import it explicitly (``from cxxnet_tpu_torch.artifact import
  bundle``): it pulls in the checkpoint module.
- :mod:`.fingerprint` — the runtime fingerprint a bundle is sealed
  for (backend ``torch``: a bundle never matches across packages).
"""

from .fingerprint import fingerprint_sha, runtime_fingerprint
from .registry import (ProgramStore, ResidencyBudgetError, kernel_key,
                       parse_key)

__all__ = ["ProgramStore", "ResidencyBudgetError", "fingerprint_sha",
           "kernel_key", "parse_key", "runtime_fingerprint"]
