"""Multi-model routing: N serve engines behind one front end (a copy of
``cxxnet_tpu/serve/router.py``, same semantics).

The :class:`ModelRouter` maps a model id to its live
:class:`~cxxnet_tpu_torch.serve.server.ServeSession`. Every entry owns its
own engine (bucket ladder, AOT executables, dispatcher threads) and
its own drain lifecycle; the router is only the atomic name -> session
indirection the protocol layer resolves through, which is what makes
zero-downtime hot-swap possible: :meth:`swap` flips the entry under
the lock and hands the *old* session back to the caller, who drains it
(``close(drain=True)``) after the flip — requests already queued on
the old engine complete, new requests land on the new one.

The one race a flip cannot close — a request that resolved the old
session but had not yet entered its queue when the drain began — is
handled one layer up: the front end retries a
:class:`~cxxnet_tpu_torch.serve.batcher.ServeClosedError` through a fresh
``resolve`` (see ``frontend.py``), so a swap is never observable as a
failed request.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..artifact.registry import ResidencyBudgetError


class UnknownModelError(KeyError):
    """Request named a model id the router does not serve."""


def session_resident_bytes(session) -> int:
    """A session's device-resident bytes: the model's frozen serve
    weight tree + retained masters (storage-deduplicated: the freeze's
    own ``weight_residency`` accounting) plus the device corpus of an
    embedding index (``session.index_bytes``). 0 when
    the engine runs without weight residency (``serve_weight_residency
    = 0``) or the session has no trainer (a test double)."""
    idx_bytes = int(getattr(session, "index_bytes", 0) or 0)
    try:
        res = session.engine.trainer.residency
    except AttributeError:
        return idx_bytes
    weight = int(res["bytes"]) if res is not None else 0
    return weight + idx_bytes


class ModelEntry:
    """One routed model: the live session plus the provenance the
    hot-swap watcher compares against (snapshot counter + path) and
    its device-memory accounting."""

    __slots__ = ("model_id", "session", "counter", "path", "generation",
                 "resident_bytes")

    def __init__(self, model_id: str, session, counter: int, path: str,
                 generation: int = 0):
        self.model_id = model_id
        self.session = session
        self.counter = counter
        self.path = path
        self.generation = generation
        self.resident_bytes = session_resident_bytes(session)


class ModelRouter:
    """Thread-safe model-id -> session table with atomic swap.

    The first registered model is the default (requests that name no
    model id route there). ``close_all`` drains every entry — the
    front-end shutdown path.

    ``mem_budget_bytes`` (0 = unlimited) makes multi-model co-location
    memory-honest: a ``register`` or ``swap`` whose per-model resident
    weight bytes would push the fleet total over the budget raises the
    typed :class:`~cxxnet_tpu_torch.artifact.registry.ResidencyBudgetError`
    — the table is untouched, so whatever was serving keeps serving
    (the hot-swap watcher treats it like any failed flip and discards
    the shadow session)."""

    def __init__(self, mem_budget_bytes: int = 0):
        self._lock = threading.Lock()
        self._models: Dict[str, ModelEntry] = {}
        self._order: List[str] = []
        self._closed = False
        self.mem_budget_bytes = int(mem_budget_bytes)

    def _check_budget(self, entry: ModelEntry,
                      replacing: Optional[str] = None) -> None:
        """Called under the lock: would installing ``entry`` (in place
        of ``replacing``) blow the budget?"""
        if not self.mem_budget_bytes:
            return
        total = entry.resident_bytes + sum(
            e.resident_bytes for m, e in self._models.items()
            if m != replacing)
        if total > self.mem_budget_bytes:
            raise ResidencyBudgetError(
                "loading model %r (%d resident bytes) would put the "
                "fleet at %d bytes, over serve_device_mem_budget (%d)"
                % (entry.model_id, entry.resident_bytes, total,
                   self.mem_budget_bytes))

    def resident_bytes_total(self) -> int:
        with self._lock:
            return sum(e.resident_bytes for e in self._models.values())

    # -- registration -----------------------------------------------------

    def register(self, model_id: str, session, counter: int = 0,
                 path: str = "") -> ModelEntry:
        with self._lock:
            if model_id in self._models:
                raise ValueError("model %r already registered"
                                 % model_id)
            entry = ModelEntry(model_id, session, counter, path)
            self._check_budget(entry)
            self._models[model_id] = entry
            self._order.append(model_id)
            return entry

    @property
    def default_id(self) -> Optional[str]:
        with self._lock:
            return self._order[0] if self._order else None

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._order)

    # -- lookup -----------------------------------------------------------

    def resolve(self, model_id: str = "") -> ModelEntry:
        """The live entry for ``model_id`` ("" = the default model).
        Raises :class:`UnknownModelError` for names never registered
        (a *swapped* model keeps its name — the entry just points at
        the new session)."""
        with self._lock:
            if not model_id:
                if not self._order:
                    raise UnknownModelError("no models registered")
                model_id = self._order[0]
            entry = self._models.get(model_id)
            if entry is None:
                raise UnknownModelError(
                    "unknown model %r (serving: %s)"
                    % (model_id, ", ".join(self._order) or "none"))
            return entry

    def describe(self) -> List[Dict[str, Any]]:
        """Model table for the HTTP ``/v1/models`` endpoint."""
        with self._lock:
            return [{"model": e.model_id, "counter": e.counter,
                     "path": e.path, "generation": e.generation,
                     "device_mem_bytes": e.resident_bytes}
                    for e in (self._models[m] for m in self._order)]

    # -- hot swap ---------------------------------------------------------

    def swap(self, model_id: str, session, counter: int,
             path: str) -> ModelEntry:
        """Atomically point ``model_id`` at ``session`` and return the
        retired entry. The caller owns draining the old session AFTER
        this returns — flip first, drain second, so there is no window
        with no live engine."""
        with self._lock:
            if self._closed:
                # a watcher finishing a shadow build after close_all
                # must not install an engine nothing will ever drain
                raise RuntimeError(
                    "router is closed; refusing to swap model %r"
                    % model_id)
            old = self._models.get(model_id)
            if old is None:
                raise UnknownModelError(
                    "cannot swap unregistered model %r" % model_id)
            entry = ModelEntry(model_id, session, counter, path,
                               generation=old.generation + 1)
            # steady-state accounting: the retired entry's bytes free
            # once it drains, so the budget compares against the
            # post-swap set (the shadow-build window transiently holds
            # both — documented in doc/serving.md)
            self._check_budget(entry, replacing=model_id)
            self._models[model_id] = entry
            return old

    # -- shutdown ---------------------------------------------------------

    def close_all(self, drain: bool = True) -> Dict[str, Dict]:
        """Close every session (idempotent); returns per-model close
        summaries keyed by model id."""
        with self._lock:
            if self._closed:
                entries = []
            else:
                self._closed = True
                entries = [self._models[m] for m in self._order]
        out = {}
        for e in entries:
            out[e.model_id] = e.session.close(drain=drain)
        return out
