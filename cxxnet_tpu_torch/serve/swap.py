"""Checkpoint-driven zero-downtime hot-swap (counterpart of
``cxxnet_tpu/serve/swap.py``).

A :class:`SnapshotWatcher` polls a model's ``model_dir`` for a newer
*verified* model — a snapshot that passes ``nnet.checkpoint.
verify_snapshot`` or a sealed bundle (``NNNN.model.bundle``) that
passes ``artifact.bundle.verify_bundle`` — builds and warms a
**shadow** session off the request path, then flips the router entry
and drains the retired session:

1. **scan** — committed candidates newest first, a bundle before a
   snapshot at the same counter, read-only (:func:`latest_verified`):
   never :func:`~cxxnet_tpu_torch.nnet.
   checkpoint.find_latest_valid`, which sweeps ``.tmp`` files and
   quarantines corrupt candidates, because a watched ``model_dir``
   usually has a live writer (the training run whose snapshots are
   served). Anything invalid or in flight is skipped, not touched.
2. **shadow build** — a full :class:`~cxxnet_tpu_torch.serve.server.
   ServeSession` (own trainer, own bucket ladder), warmed on its
   dispatch thread before the flip, so the first request on it pays no
   first-use cost. A bundle that seals an embedding index builds and
   warms its retrieval engine inside that session (the corpus on the
   device), so model and index flip as one pair.
3. **flip** — ``router.swap`` replaces the entry atomically.
4. **drain** — the retired session ``close(drain=True)``s; the front
   end retries the one race a flip cannot close (resolved the old
   session, submitted after its drain began) through a fresh resolve.

While the entry serves a snapshot, a bundle that commits at the same
counter (an export of the served snapshot) swaps in too; one that
fails verification warns once and is not re-hashed until its commit
marker is rewritten. Every swap emits a ``hot_swap`` record; a failed
shadow build warns and leaves the old session serving.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..artifact.bundle import (BUNDLE_RE, MANIFEST_NAME, OK_SUFFIX,
                               member_uri, scan_bundles, verify_bundle)
from ..monitor import warn_once
from ..nnet.checkpoint import (MODEL_RE, scan_snapshots, snapshot_uri,
                               verify_snapshot)
from ..utils.stream import local_path, read_stream_bytes, uri_scheme
from .router import ModelRouter


def latest_verified(model_dir: str, min_counter: int = -1,
                    ) -> Tuple[Optional[int], Optional[str]]:
    """Newest verified model in ``model_dir`` — a snapshot that passes
    ``verify_snapshot`` or a bundle that passes ``verify_bundle`` — as
    (counter, uri); (None, None) when none does. At an equal counter
    the bundle wins. ``min_counter`` prunes candidates at or below it
    before they are verified (the idle poll costs a listing, not a
    re-hash). Read-only: safe against a ``model_dir`` a live writer
    commits into."""
    try:
        candidates = [(c, n, False) for c, n in scan_snapshots(model_dir)]
        candidates += [(c, n, True) for c, n in scan_bundles(model_dir)]
    except (IOError, OSError):
        return None, None
    candidates.sort(key=lambda c: (c[0], c[2]), reverse=True)
    for counter, name, bundle in candidates:
        if counter <= min_counter:
            break                        # sorted: nothing newer left
        uri = snapshot_uri(model_dir, name)
        rep = verify_bundle(uri) if bundle else verify_snapshot(uri)
        if rep["ok"]:
            return counter, uri
    return None, None


def counter_of(path: str) -> int:
    """Snapshot or bundle counter from an ``NNNN.model.npz`` /
    ``NNNN.model.bundle`` basename (0 when the name follows neither:
    an explicit model_in file, which any watched counter >= 1
    upgrades)."""
    base = os.path.basename(path.rstrip("/"))
    m = MODEL_RE.match(base) or BUNDLE_RE.match(base)
    return int(m.group(1)) if m else 0


class SnapshotWatcher:
    """Poll one model's directory and hot-swap on a newer verified
    snapshot or bundle.

    ``builder(path)`` returns a warmed ``ServeSession`` for the
    snapshot or bundle at ``path`` (the front end passes its session factory).
    ``check_once()`` is the synchronous core; the poll thread calls it
    every ``poll_s`` seconds, and ``notify()`` wakes it at once.
    """

    def __init__(self, router: ModelRouter, model_id: str,
                 model_dir: str,
                 builder: Callable[[str], Any],
                 poll_s: float = 2.0, monitor=None):
        self.router = router
        self.model_id = model_id
        self.model_dir = model_dir
        self.builder = builder
        self.poll_s = max(0.05, float(poll_s))
        self._mon = monitor
        self._stop = threading.Event()
        # the notify() kick: an in-process writer wakes the poll thread
        # the instant it commits; external writers keep the poll_s
        # cadence
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes scan -> build -> flip -> drain and guards the
        # counters: two overlapping calls that saw the same snapshot
        # would build twice and drain the session the first installed
        self._lock = threading.Lock()
        self.swaps = 0
        self.failed_builds = 0
        # the same-counter bundle probe's negative cache: uri -> the
        # commit-marker bytes that failed verification (a re-export
        # rewrites the marker, which retries)
        self._bad_upgrade: Dict[str, bytes] = {}

    # -- the swap core ----------------------------------------------------

    def check_once(self) -> Optional[Dict[str, Any]]:
        """One poll: swap if a newer verified model exists, or a bundle
        at the served snapshot's counter. Returns the ``hot_swap``
        record fields on a swap, None otherwise. Never raises: a failed
        shadow build warns and leaves the current session serving."""
        with self._lock:
            try:
                current = self.router.resolve(self.model_id)
            except KeyError:
                return None
            counter, path = latest_verified(
                self.model_dir, min_counter=current.counter)
            if counter is None:
                counter, path = self._bundle_upgrade(current)
                if counter is None:
                    return None
            if counter < current.counter or path == current.path:
                return None
            t0 = time.monotonic()
            try:
                # the router still serves the old session meanwhile
                session = self.builder(path)
            except Exception as e:
                self.failed_builds += 1
                self._warn("hot_swap_build_failed:%s" % path,
                           "hot-swap of model %r to %s failed to build "
                           "(%s); keeping the current engine"
                           % (self.model_id, path, e))
                return None
            try:
                old = self.router.swap(self.model_id, session, counter,
                                       path)
            except Exception as e:
                # router refused (closed mid-build, over the budget):
                # the shadow session must not leak its threads
                session.close(drain=False)
                self._warn("hot_swap_flip_failed:%s" % path,
                           "hot-swap of model %r to %s could not flip "
                           "(%s); shadow engine discarded"
                           % (self.model_id, path, e))
                return None
            # drain after the flip: new traffic lands on the shadow
            # session, old traffic finishes on the retiring one
            old_summary = old.session.close(drain=True)
            self.swaps += 1
            rec = {
                "model": self.model_id,
                "old_counter": old.counter,
                "new_counter": counter,
                "path": path,
                "warmup_programs": int(
                    getattr(session, "warmup_programs", 0)),
                "old_requests": int(old_summary.get("requests", 0)),
                "old_compile_events": int(
                    old_summary.get("compile_events", 0)),
                "wall_ms": (time.monotonic() - t0) * 1e3,
            }
            if self._mon is not None and self._mon.enabled:
                try:
                    self._mon.emit("hot_swap", **rec)
                except Exception:
                    # telemetry must not kill swaps; a broken sink
                    # warns once instead of passing silently
                    self._warn("hot_swap_emit_failed",
                               "hot_swap record for model %r could "
                               "not be emitted" % self.model_id)
            return rec

    def _bundle_upgrade(self, current) -> Tuple[Optional[int],
                                                Optional[str]]:
        """A committed bundle at the served counter while the entry
        serves a snapshot: (counter, uri) once it verifies, else (None,
        None). Cheap (a listing and a marker's existence) until such a
        bundle appears; one that fails verification warns once and is
        skipped until its marker is rewritten."""
        if BUNDLE_RE.match(os.path.basename(
                (current.path or "").rstrip("/"))):
            return None, None            # already serving a bundle
        try:
            bundles = scan_bundles(self.model_dir)
        except (IOError, OSError):
            return None, None
        for c, name in bundles:
            if c != current.counter:
                continue
            uri = snapshot_uri(self.model_dir, name)
            if uri == current.path:
                return None, None
            marker = self._read_marker(uri)
            if marker is not None \
                    and self._bad_upgrade.get(uri) == marker:
                return None, None        # the same failed bytes
            # the shadow build's load_bundle verifies again at read time
            rep = verify_bundle(uri)
            if rep["ok"]:
                self._bad_upgrade.pop(uri, None)
                return c, uri
            if marker is not None:
                self._bad_upgrade[uri] = marker
            self._warn("bundle_upgrade_invalid:%s" % uri,
                       "bundle %s at the served counter fails "
                       "verification (%s); staying on the snapshot "
                       "(re-export to retry)" % (uri, rep["error"]))
            return None, None
        return None, None

    @staticmethod
    def _read_marker(uri: str) -> Optional[bytes]:
        """The negative-cache key of a bundle: its commit-marker bytes
        and, on a local path, the marker's mtime (a deterministic
        re-export writes the same marker bytes); None when unreadable."""
        ok = member_uri(uri, MANIFEST_NAME + OK_SUFFIX)
        try:
            data = read_stream_bytes(ok)
            if not uri_scheme(ok):
                data += b"@%d" % os.stat(local_path(ok)).st_mtime_ns
            return data
        except (IOError, OSError):
            return None

    def _warn(self, code: str, message: str) -> None:
        if self._mon is not None:
            self._mon.warn_once(code, message)
        else:
            warn_once(code, message)

    # -- poll thread ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self._thread = threading.Thread(
            target=self._loop, name="serve-watch-%s" % self.model_id,
            daemon=True)
        self._thread.start()

    def notify(self) -> None:
        """Wake the poll thread for an immediate check (a notify that
        lands during a check schedules one more pass). Safe from any
        thread; before ``start()`` it makes the first poll immediate."""
        self._kick.set()

    def _loop(self) -> None:
        while True:
            self._kick.wait(self.poll_s)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.check_once()
            except Exception as e:
                # the watcher outlives any one bad poll (a transient
                # remote-list error)
                self._warn("hot_swap_poll_failed",
                           "hot-swap poll for model %r failed: %s"
                           % (self.model_id, e))

    def close(self) -> None:
        self._stop.set()
        self._kick.set()                 # wake a sleeping poll now
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
