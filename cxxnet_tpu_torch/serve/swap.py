"""Checkpoint-driven zero-downtime hot-swap (counterpart of
``cxxnet_tpu/serve/swap.py``).

A :class:`SnapshotWatcher` polls a model's ``model_dir`` for a newer
*verified* snapshot (``nnet.checkpoint.verify_snapshot``: digest and
structure checked before a byte is trusted), builds and warms a
**shadow** session off the request path, then flips the router entry
and drains the retired session:

1. **scan** — committed candidates newest first, read-only
   (:func:`latest_verified`): never :func:`~cxxnet_tpu_torch.nnet.
   checkpoint.find_latest_valid`, which sweeps ``.tmp`` files and
   quarantines corrupt candidates, because a watched ``model_dir``
   usually has a live writer (the training run whose snapshots are
   served). Anything invalid or in flight is skipped, not touched.
2. **shadow build** — a full :class:`~cxxnet_tpu_torch.serve.server.
   ServeSession` (own trainer, own bucket ladder), warmed on its
   dispatch thread before the flip, so the first request on it pays no
   first-use cost.
3. **flip** — ``router.swap`` replaces the entry atomically.
4. **drain** — the retired session ``close(drain=True)``s; the front
   end retries the one race a flip cannot close (resolved the old
   session, submitted after its drain began) through a fresh resolve.

Every swap emits a ``hot_swap`` record; a failed shadow build warns and
leaves the old session serving.

Sealed bundles (``NNNN.model.bundle``) are not ported (ROADMAP queue 1,
sealed bundles). The reference boots the newest verified entry and,
at equal counters, prefers a bundle; the port cannot verify or load
one, so it never serves one silently: a committed bundle that would be
the newest entry at boot raises :class:`~cxxnet_tpu_torch.utils.config.
NotPortedError` (:func:`newest_model`), and one that commits while the
watcher serves a snapshot is skipped with one warning per bundle.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..monitor import warn_once
from ..nnet.checkpoint import (MODEL_RE, OK_SUFFIX, scan_snapshots,
                               snapshot_uri, verify_snapshot)
from ..utils.config import NotPortedError, Roadmap
from ..utils.stream import list_stream_dir, stream_exists
from .router import ModelRouter

# the reference's bundle naming (cxxnet_tpu/artifact/bundle.py): a
# directory whose commit marker is MANIFEST.json.ok
BUNDLE_RE = re.compile(r"^(\d{4})\.model\.bundle$")
BUNDLE_MANIFEST = "MANIFEST.json"


def scan_bundles(model_dir: str) -> List[Tuple[int, str]]:
    """Committed bundle candidates in ``model_dir`` as (counter,
    basename), newest first; a bundle without its commit marker may
    still be being written and is left out. Read-only."""
    out = []
    for n in list_stream_dir(model_dir):
        m = BUNDLE_RE.match(n)
        if not m:
            continue
        marker = snapshot_uri(snapshot_uri(model_dir, n),
                              BUNDLE_MANIFEST + OK_SUFFIX)
        if stream_exists(marker):
            out.append((int(m.group(1)), n))
    out.sort(reverse=True)
    return out


def is_bundle(path: str) -> bool:
    """True when ``path`` is a bundle directory (committed or not)."""
    return stream_exists(snapshot_uri(path, BUNDLE_MANIFEST))


def latest_verified(model_dir: str, min_counter: int = -1,
                    ) -> Tuple[Optional[int], Optional[str]]:
    """Newest snapshot in ``model_dir`` that passes
    ``verify_snapshot``, as (counter, uri); (None, None) when none
    does. ``min_counter`` prunes candidates at or below it before they
    are verified (the idle poll costs a listing, not a re-hash).
    Read-only: safe against a ``model_dir`` a live writer commits
    into."""
    try:
        candidates = scan_snapshots(model_dir)
    except (IOError, OSError):
        return None, None
    for counter, name in candidates:         # newest first
        if counter <= min_counter:
            break
        uri = snapshot_uri(model_dir, name)
        if verify_snapshot(uri)["ok"]:
            return counter, uri
    return None, None


def newest_model(model_dir: str) -> Tuple[Optional[int], Optional[str]]:
    """What a ``model_dir`` source boots: :func:`latest_verified`.
    Raises NotPortedError when a committed bundle is at least as new
    (the reference would boot that bundle)."""
    counter, path = latest_verified(model_dir)
    try:
        bundles = scan_bundles(model_dir)
    except (IOError, OSError):
        bundles = []
    if bundles and (counter is None or bundles[0][0] >= counter):
        raise NotPortedError(
            "the sealed bundle %s, the newest model in %r"
            % (bundles[0][1], model_dir), Roadmap.BUNDLES)
    return counter, path


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
    snapshot.

    ``builder(path)`` returns a warmed ``ServeSession`` for the
    snapshot at ``path`` (the front end passes its session factory).
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

    # -- the swap core ----------------------------------------------------

    def check_once(self) -> Optional[Dict[str, Any]]:
        """One poll: swap if a newer verified snapshot exists. Returns
        the ``hot_swap`` record fields on a swap, None otherwise. Never
        raises: a failed shadow build warns and leaves the current
        session serving."""
        with self._lock:
            try:
                current = self.router.resolve(self.model_id)
            except KeyError:
                return None
            self._skip_bundles(current.counter)
            counter, path = latest_verified(
                self.model_dir, min_counter=current.counter)
            if counter is None or path == current.path:
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

    def _skip_bundles(self, served: int) -> None:
        """Warn once for each committed bundle at or past the served
        counter: the reference would swap to it; the port keeps
        serving snapshots."""
        try:
            bundles = scan_bundles(self.model_dir)
        except (IOError, OSError):
            return
        for c, name in bundles:
            if c < served:
                break
            self._warn("hot_swap_bundle_skipped:%s" % name,
                       "bundle %s in %r is not served: sealed bundles "
                       "are not ported to cxxnet_tpu_torch yet "
                       "(ROADMAP.md %s); model %r keeps serving snapshots"
                       % (name, self.model_dir, Roadmap.BUNDLES,
                          self.model_id))

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
