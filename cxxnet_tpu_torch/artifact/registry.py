"""The program store of sealed bundles (counterpart of
``cxxnet_tpu/artifact/registry.py``).

The reference seals its compiled XLA executables, so that a boot on a
matching runtime compiles nothing. The port's compiled device code is
the ``nvcc`` output of ``csrc/*.cu``, which ``layers/kernels.py`` builds
at first use into ``_build/<name>-<sha16>.so`` (the hash covers the
source and ``NVCC_FLAGS``). So a port bundle's programs are kernel
libraries, one member each:

- **which**: the libraries the frozen serve path loaded
  (:attr:`ProgramStore.libraries`, filled by ``NetTrainer.pred`` through
  ``kernels.record_libraries``), keyed ``("kernel", name, sha16)``. An
  export on the CPU loads none and seals none;
- **install**: a boot whose fingerprint matches writes each library
  whose hash is this tree's to its path (a *hit*: ``build_kernels``
  finds it and runs no ``nvcc``); a stale hash, a key of another kind
  or an unwritable path is a *rebuild*, with one warning, and ``nvcc``
  builds that library at first use as it always does. ``hits +
  rebuilds == len(programs)``, always;
- **re-export** copies the installed keys' original bytes from the
  source bundle (``bundle._source_blobs``), as the reference does.

The port never unpickles a member: a reference bundle's programs are
pickled JAX executables, and loading one would import ``jax``. Its
fingerprint (backend ``jax``) never equals the port's (backend
``torch``), so a bundle that crosses packages always takes the rebuild
path, in both directions. The reference's JAX compile loop and
dispatch-signature scheme are not ported: eager PyTorch has no
programs to key.

Keys are tuples of primitives: ``repr(key)`` is the manifest's
encoding and :func:`parse_key` recovers it, in either package.
"""

from __future__ import annotations

import ast
import time
from typing import Any, Dict, List, Sequence, Set, Tuple

KERNEL_KIND = "kernel"


class ResidencyBudgetError(RuntimeError):
    """Loading (or hot-swapping in) a model would exceed the explicit
    ``serve_device_mem_budget`` — the memory-honest alternative to
    discovering the overcommit as a device OOM mid-request. The load
    is rejected whole; whatever was serving keeps serving."""


def parse_key(text: str) -> tuple:
    """Recover a program key from its ``repr`` (the bundle manifest
    encoding). Keys are tuples of primitives, so ``literal_eval`` is
    exact; anything else raises ValueError."""
    key = ast.literal_eval(text)
    if not isinstance(key, tuple) or not key \
            or not isinstance(key[0], str):
        raise ValueError("not a registry key: %r" % text)
    return key


def kernel_key(name: str) -> tuple:
    """The program key of kernel library ``name`` as this tree builds
    it."""
    from ..layers.kernels import library_key
    return (KERNEL_KIND, name, library_key(name)[0])


class ProgramStore:
    """The kernel libraries of one trainer's serve path, and the
    accounting of a bundle boot. ``reset`` runs when the trainer builds
    a net (``init_model`` / ``load_model``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.libraries: Set[str] = set()
        self.bundle_path = ""
        # keys installed from bundle_path: re-export copies their
        # original member bytes
        self.installed: Set[tuple] = set()

    def serialize(self, monitor=None) -> List[Tuple[tuple, bytes]]:
        """``(key, library bytes)`` of every library the serve path
        loaded that was not installed from a bundle (those ship their
        original bytes). A library missing from its path warns and is
        left out: the bundle still boots, and that library rebuilds."""
        from ..layers.kernels import library_key
        out: List[Tuple[tuple, bytes]] = []
        for name in sorted(self.libraries):
            key = kernel_key(name)
            if key in self.installed:
                continue
            so = library_key(name)[1]
            try:
                with open(so, "rb") as f:
                    out.append((key, f.read()))
            except OSError as e:
                _warn(monitor, "artifact_serialize_failed",
                      "kernel library %s is unreadable (%s); the bundle "
                      "ships without it and a boot rebuilds it"
                      % (so, e))
        return out

    def install(self, programs: Sequence[Tuple[tuple, bytes]], path: str,
                fingerprint_ok: bool, monitor=None) -> Dict[str, Any]:
        """Install a bundle's (digest-checked) libraries. A mismatched
        fingerprint installs nothing: one warning, and every key is a
        rebuild. Returns the ``artifact_load`` record fields."""
        from ..layers.kernels import install_library
        t0 = time.perf_counter()
        hits = rebuilds = 0
        self.bundle_path = path
        if not fingerprint_ok:
            rebuilds = len(programs)
            _warn(monitor, "artifact_fingerprint_mismatch",
                  "artifact bundle %s was sealed on a different "
                  "backend/device/runtime; its %d program(s) are "
                  "unusable here — every kernel library it carries "
                  "builds from source instead (results are unaffected)"
                  % (path, len(programs)))
        else:
            for key, blob in programs:
                why = ""
                if len(key) != 3 or key[0] != KERNEL_KIND:
                    why = "it is not a kernel library"
                else:
                    try:
                        if not install_library(key[1], key[2], blob):
                            why = "this tree's source hash differs"
                    except OSError as e:
                        why = "its library cannot be written (%s)" % e
                if why:
                    rebuilds += 1
                    _warn(monitor,
                          "artifact_program_rebuilt:%r" % (key,),
                          "bundle program %r is not installed: %s; it "
                          "builds from source at first use" % (key, why))
                    continue
                self.installed.add(key)
                hits += 1
        return {"path": path,
                "fingerprint_match": bool(fingerprint_ok),
                "hits": hits, "rebuilds": rebuilds,
                "wall_ms": (time.perf_counter() - t0) * 1e3}


def _warn(monitor, code: str, message: str) -> None:
    if monitor is not None:
        monitor.warn_once(code, message)
    else:
        from ..monitor import warn_once
        warn_once(code, message)
