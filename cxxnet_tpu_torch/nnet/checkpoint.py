"""Crash-safe snapshots: atomic commit, digests, async writes, resume
(counterpart of ``cxxnet_tpu/nnet/checkpoint.py``).

A snapshot is an npz of ``param/<layer>/<tag>``, ``state/<layer>/<name>``
(and ``opt/``, ``quant/``) arrays plus a ``__meta__`` JSON record
carrying ``format_version`` 2 and a ``content_digest`` (sha256 over
every array's name, dtype, shape and bytes). A snapshot written by
either package loads in the other with its digest verified.

* **atomic two-phase commit**: a local path writes a ``.tmp`` sibling,
  fsyncs it and renames it over the final name; a ``scheme://`` URI
  writes the payload and then a ``<name>.ok`` commit manifest, and a
  payload without its manifest is invisible to resume.
* **async snapshots**: :class:`CheckpointManager` leaves the training
  thread only the gather (``NetTrainer.gather_snapshot``, host copies
  that no later update can change); one background writer serializes,
  commits and sweeps old snapshots (``keep_snapshots``).
* **validated resume**: :func:`find_latest_valid` scans a model dir
  newest first, quarantines corrupt candidates and returns the newest
  snapshot that verifies.

A managed (CLI) snapshot that fails to commit warns and training goes
on; the direct ``NetTrainer.save_model`` raises. The port runs in one
process, so it is always the root that writes. Under an enabled
``monitor`` the manager emits a ``checkpoint`` record per commit (its
phase split, ``async_write``, ``emergency``) and a ``checkpoint_gc``
record per retention sweep that removed snapshots; warnings go through
``monitor.warn_once`` (once per code and run, into the run's stream).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..monitor import warn_once
from ..utils.stream import (list_stream_dir, local_path, open_stream,
                            read_stream_bytes, remove_stream,
                            stream_exists, uri_scheme)

# format_version 2 = digest-carrying snapshots (this module); 1 = the
# pre-checkpoint-subsystem layout (no content_digest — still loadable).
FORMAT_VERSION = 2

MODEL_RE = re.compile(r"^(\d{4})\.model\.npz$")
_TMP_RE = re.compile(r"^\d{4}\.model\.npz\.tmp$")

OK_SUFFIX = ".ok"
QUARANTINE_SUFFIX = ".quarantined"


class SnapshotError(IOError):
    """Base for snapshot read failures."""


class SnapshotIntegrityError(SnapshotError):
    """Snapshot is unreadable, truncated, or fails its digest."""


class SnapshotFormatError(SnapshotError):
    """Snapshot was written by a newer format than this build reads."""


# -- digest ---------------------------------------------------------------


def compute_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Order-independent sha256 over every array's identity (name,
    dtype, shape) and bytes; ``__meta__`` is excluded — the digest
    lives inside it."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        if k == "__meta__":
            continue
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return "sha256:" + h.hexdigest()


def _serialize(arrays: Dict[str, np.ndarray],
               meta: Dict[str, Any]) -> Tuple[bytes, str]:
    """Digest the arrays, stamp the digest + format version into
    ``__meta__``, and return (npz bytes, digest)."""
    digest = compute_digest(arrays)
    meta = dict(meta)
    meta["format_version"] = FORMAT_VERSION
    meta["content_digest"] = digest
    out = dict(arrays)
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue(), digest


# -- atomic commit --------------------------------------------------------


def write_snapshot(path: str, arrays: Dict[str, np.ndarray],
                   meta: Dict[str, Any],
                   fsync: bool = True) -> Dict[str, Any]:
    """Serialize and atomically commit a snapshot; returns timing/size
    stats for the ``checkpoint`` telemetry record.

    Local paths: write ``<path>.tmp``, flush+fsync, ``os.replace`` to
    the final name, fsync the directory — a crash at any point leaves
    either the previous committed snapshot or the new one. Remote
    schemes: write the payload, then the ``<path>.ok`` commit manifest
    (bytes + file sha256 + content digest); resume and GC treat a
    manifest-less payload as uncommitted.
    """
    t0 = time.perf_counter()
    payload, digest = _serialize(arrays, meta)
    t1 = time.perf_counter()
    fsync_s = 0.0
    if uri_scheme(path):
        # re-writing a committed counter (emergency snapshots reuse
        # the in-progress round's number): drop the old manifest FIRST
        # so a kill mid-overwrite leaves an *uncommitted* payload, not
        # a torn payload a stale manifest still vouches for
        remove_stream(path + OK_SUFFIX)
        with open_stream(path, "wb") as f:
            f.write(payload)
        manifest = {
            "format_version": FORMAT_VERSION,
            "bytes": len(payload),
            "file_sha256": hashlib.sha256(payload).hexdigest(),
            "content_digest": digest,
        }
        with open_stream(path + OK_SUFFIX, "w") as f:
            f.write(json.dumps(manifest))
        # a re-written counter must not stay masked by a stale
        # quarantine marker from a previous resume scan
        remove_stream(path + QUARANTINE_SUFFIX)
        t2 = time.perf_counter()
    else:
        p = local_path(path)
        d = os.path.dirname(p)
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)
        tmp = p + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                if fsync:
                    tf = time.perf_counter()
                    os.fsync(f.fileno())
                    fsync_s += time.perf_counter() - tf
            os.replace(tmp, p)
        except BaseException:
            # leave no droppings: the tmp sibling is garbage by
            # definition (resume ignores it, but ENOSPC recovery
            # should not have to wait for the next scan)
            try:
                os.remove(tmp)
            except OSError:
                pass    # best-effort: the commit failure is what counts
            raise
        if fsync and d:
            # the rename itself must be durable: fsync the directory
            tf = time.perf_counter()
            try:
                dfd = os.open(d, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError as e:
                # some filesystems refuse dir fsync: the rename may
                # not be power-loss durable — warn once, keep going
                warn_once("dir_fsync_refused",
                          "directory fsync of %r failed (%s); the "
                          "snapshot rename is not guaranteed durable "
                          "across power loss on this filesystem"
                          % (d, e))
            fsync_s += time.perf_counter() - tf
        t2 = time.perf_counter()
    # optimizer-state share of the payload (save_optimizer = 1
    # snapshots carry opt/<layer>/<tag>/<key> arrays)
    opt_bytes = sum(int(a.nbytes) for k, a in arrays.items()
                    if k.startswith("opt/"))
    return {
        "bytes": len(payload),
        "opt_bytes": opt_bytes,
        "digest": digest,
        "serialize_ms": (t1 - t0) * 1e3,
        "write_ms": max(0.0, (t2 - t1) * 1e3 - fsync_s * 1e3),
        "fsync_ms": fsync_s * 1e3,
    }


# -- verified read --------------------------------------------------------


def read_snapshot(path: str, verify: bool = True, raw: bytes = None,
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a snapshot into (arrays, meta), raising
    :class:`SnapshotIntegrityError` on truncation/corruption/digest
    mismatch and :class:`SnapshotFormatError` on a future
    ``format_version``. v1 snapshots (pre-digest) load with a warn-once
    instead of failing — old fleets must stay resumable. ``raw`` lets a
    caller that already holds the payload bytes (verify_snapshot's
    manifest cross-check) skip a second full fetch."""
    if raw is None:
        try:
            raw = read_stream_bytes(path)
        except (IOError, OSError) as e:
            raise SnapshotIntegrityError(
                "snapshot %r is unreadable: %s" % (path, e)) from e
    try:
        blob = dict(np.load(io.BytesIO(raw), allow_pickle=False))
    except Exception as e:
        raise SnapshotIntegrityError(
            "snapshot %r is corrupt or truncated (%d bytes): %s"
            % (path, len(raw), e)) from e
    if "__meta__" not in blob:
        raise SnapshotIntegrityError(
            "snapshot %r has no __meta__ record" % path)
    try:
        meta = json.loads(bytes(blob["__meta__"]).decode())
    except Exception as e:
        raise SnapshotIntegrityError(
            "snapshot %r has an unparseable __meta__: %s"
            % (path, e)) from e
    fv = int(meta.get("format_version", 1))
    if fv > FORMAT_VERSION:
        raise SnapshotFormatError(
            "snapshot %r was written by format_version %d but this "
            "build reads <= %d; upgrade the package (or re-export "
            "the snapshot) instead of guessing at the layout"
            % (path, fv, FORMAT_VERSION))
    if verify:
        digest = meta.get("content_digest")
        if digest:
            got = compute_digest(blob)
            if got != digest:
                raise SnapshotIntegrityError(
                    "snapshot %r fails its content digest (stored %s, "
                    "recomputed %s) — the file was modified or "
                    "corrupted after commit" % (path, digest, got))
        else:
            warn_once("snapshot_no_digest",
                      "snapshot %r carries no content digest "
                      "(format_version %d) — loading unverified"
                      % (path, fv))
    return blob, meta


def verify_snapshot(path: str) -> Dict[str, Any]:
    """Integrity report for one snapshot: structural loadability and
    digest, plus the commit-manifest cross-check when one exists."""
    rep: Dict[str, Any] = {"path": path, "ok": False, "error": "",
                           "bytes": 0, "format_version": 0,
                           "digest": "missing"}
    try:
        raw = read_stream_bytes(path)
    except (IOError, OSError) as e:
        rep["error"] = "unreadable: %s" % e
        return rep
    rep["bytes"] = len(raw)
    if stream_exists(path + OK_SUFFIX):
        try:
            with open_stream(path + OK_SUFFIX, "r") as f:
                man = json.loads(f.read())
            if man.get("bytes") != len(raw):
                rep["error"] = ("manifest size mismatch: committed %s "
                                "bytes, found %d"
                                % (man.get("bytes"), len(raw)))
                return rep
            sha = hashlib.sha256(raw).hexdigest()
            if man.get("file_sha256") not in (None, sha):
                rep["error"] = "manifest file_sha256 mismatch"
                return rep
        except (IOError, OSError, ValueError) as e:
            rep["error"] = "unreadable commit manifest: %s" % e
            return rep
    try:
        blob, meta = read_snapshot(path, verify=False, raw=raw)
    except SnapshotError as e:
        rep["error"] = str(e)
        return rep
    rep["format_version"] = int(meta.get("format_version", 1))
    digest = meta.get("content_digest")
    if digest:
        if compute_digest(blob) == digest:
            rep["digest"] = "match"
        else:
            rep["digest"] = "mismatch"
            rep["error"] = "content digest mismatch"
            return rep
    rep["ok"] = True
    return rep


# -- model_dir scan / validated resume ------------------------------------


def snapshot_uri(model_dir: str, name: str) -> str:
    if uri_scheme(model_dir):
        return "%s/%s" % (model_dir.rstrip("/"), name)
    return os.path.join(local_path(model_dir), name)


def scan_snapshots(model_dir: str) -> List[Tuple[int, str]]:
    """Committed snapshot candidates in ``model_dir`` as
    (counter, basename), newest first. Remote dirs require the
    ``.ok`` commit manifest and skip quarantine-marked names; local
    dirs list every final-named file (the local commit IS the rename).
    Read-only: stale ``.tmp`` sweeping belongs to the resume scan
    (:func:`find_latest_valid`); a verifier may be pointed at a
    model_dir a live run is committing into, and must never delete its
    in-flight tmp."""
    names = set(list_stream_dir(model_dir))
    remote = bool(uri_scheme(model_dir))
    out = []
    for n in names:
        m = MODEL_RE.match(n)
        if not m:
            continue
        if remote:
            if n + OK_SUFFIX not in names:
                continue                 # uncommitted payload
            if n + QUARANTINE_SUFFIX in names:
                continue                 # marked bad by a prior resume
        out.append((int(m.group(1)), n))
    out.sort(reverse=True)
    return out


class ResumeReport:
    """Outcome of a validated resume scan."""

    __slots__ = ("path", "counter", "scanned", "quarantined")

    def __init__(self, path: Optional[str], counter: Optional[int],
                 scanned: int, quarantined: List[str]):
        self.path = path
        self.counter = counter
        self.scanned = scanned
        self.quarantined = quarantined


def quarantine_snapshot(model_dir: str, name: str) -> None:
    """Move a corrupt candidate out of resume's way, preserving the
    bytes for forensics: local files rename to ``<name>.quarantined``
    (with a numeric suffix if that exists); remote objects get a
    ``<name>.quarantined`` marker object beside them."""
    uri = snapshot_uri(model_dir, name)
    if uri_scheme(model_dir):
        try:
            with open_stream(uri + QUARANTINE_SUFFIX, "w") as f:
                f.write("quarantined by resume scan\n")
        except (IOError, OSError) as e:
            # skip-only quarantine on read-only remote stores: the
            # resume scan still skips the corrupt snapshot, but every
            # future scan re-verifies it — worth saying once
            warn_once("quarantine_failed:%s" % uri,
                      "could not write quarantine marker for %s (%s); "
                      "the snapshot is skipped but will be re-verified "
                      "on every scan" % (uri, e))
        return
    dst = uri + QUARANTINE_SUFFIX
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = "%s%s.%d" % (uri, QUARANTINE_SUFFIX, n)
    try:
        os.replace(uri, dst)
    except OSError as e:
        warn_once("quarantine_failed:%s" % uri,
                  "could not quarantine corrupt snapshot %s (%s); it "
                  "stays in place and every scan re-verifies it"
                  % (uri, e))


def find_latest_valid(model_dir: str, monitor=None,
                      quarantine: bool = True) -> ResumeReport:
    """Scan ``model_dir`` newest-first and return the newest snapshot
    that actually verifies; corrupt candidates are quarantined (and
    warned about once) instead of crashing ``continue=1``. Resume owns
    the model_dir (no live writer), so stale local ``.tmp`` siblings
    left by a kill mid-commit are swept here."""
    if not uri_scheme(model_dir):
        for n in list_stream_dir(model_dir):
            if _TMP_RE.match(n):
                try:
                    os.remove(snapshot_uri(model_dir, n))
                except OSError:
                    pass    # resume ignores .tmp files either way
    bad: List[str] = []
    scanned = 0
    for counter, name in scan_snapshots(model_dir):
        scanned += 1
        uri = snapshot_uri(model_dir, name)
        rep = verify_snapshot(uri)
        if rep["ok"]:
            return ResumeReport(uri, counter, scanned, bad)
        bad.append(name)
        if quarantine:
            quarantine_snapshot(model_dir, name)
        warn_once("snapshot_quarantined:%s" % name,
                  "resume: snapshot %s is invalid (%s); %s"
                  % (uri, rep["error"],
                     "quarantined" if quarantine else "skipped"))
    return ResumeReport(None, None, scanned, bad)


# -- retention ------------------------------------------------------------


def retention_sweep(model_dir: str, keep: int) -> List[str]:
    """Delete committed snapshots beyond the newest ``keep`` (never
    fewer than one survives). Remote deletes drop the commit manifest
    first so a partial sweep can never leave a committed-but-missing
    payload. Returns the basenames removed."""
    if keep <= 0:
        return []
    removed = []
    for _, name in scan_snapshots(model_dir)[keep:]:
        uri = snapshot_uri(model_dir, name)
        if uri_scheme(model_dir):
            remove_stream(uri + OK_SUFFIX)
        remove_stream(uri)
        removed.append(name)
    return removed


# -- async writer / manager -----------------------------------------------


class _Writer:
    """Single in-flight background commit thread: ``submit`` joins the
    previous write (bounding buffered snapshots to one) and starts the
    next; ``close`` drains."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()
        t = threading.Thread(target=fn, name="ckpt-writer",
                             daemon=True)
        t.start()
        self._thread = t

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None


class CheckpointManager:
    """The train loop's checkpoint front end.

    ``save(counter)`` gathers the device arrays to host copies on the
    calling (training) thread, the only part that must see a quiescent
    update boundary, and hands serialization, the atomic commit and the
    retention sweep to the background writer (``checkpoint_async = 0``
    runs them inline). Commit failures warn and training goes on:
    crash safety means surviving ENOSPC, not dying on it.
    ``last_save`` holds the training thread's share of the last
    ``save`` (``gather_ms``, ``save_ms``) and ``last_commit`` the
    writer's stats of the last commit; an enabled ``monitor`` gets them
    as ``checkpoint`` records (see the module docstring).
    """

    def __init__(self, trainer, path_for: Callable[[int], str],
                 model_dir: str = "", monitor=None, async_: bool = True,
                 fsync: bool = True, keep: int = 0):
        self.trainer = trainer
        self.path_for = path_for
        self.model_dir = model_dir
        self._mon = monitor if monitor is not None and monitor.enabled \
            else None
        self.async_ = bool(async_)
        self.fsync = bool(fsync)
        self.keep = int(keep)
        self._writer = _Writer()
        # commits/failures are written on the background writer thread
        # and read by the training thread (tests, the emergency path's
        # accounting) — guarded, so a reader never sees a torn update
        self._lock = threading.Lock()
        self.failures = 0
        self.commits = 0
        self.last_save: Dict[str, float] = {}
        self.last_commit: Dict[str, Any] = {}

    def save(self, counter: int, emergency: bool = False) -> None:
        t0 = time.perf_counter()
        arrays, meta = self.trainer.gather_snapshot()
        gather_ms = (time.perf_counter() - t0) * 1e3
        path = self.path_for(counter)

        def _commit():
            stats = {"bytes": 0, "opt_bytes": 0, "digest": "",
                     "serialize_ms": 0.0, "write_ms": 0.0,
                     "fsync_ms": 0.0}
            status, err = "ok", ""
            try:
                stats = write_snapshot(path, arrays, meta,
                                       fsync=self.fsync)
            except Exception as e:
                # commit failures (ENOSPC, auth, a backend bug) warn and
                # training goes on; nothing escapes the writer thread
                status, err = "failed", str(e)
                warn_once("checkpoint_write_failed",
                          "snapshot %s failed (%s); training continues "
                          "on the previous committed snapshot"
                          % (path, e))
            with self._lock:
                if status == "ok":
                    self.commits += 1
                    self.last_commit = dict(stats, path=path, status="ok",
                                            emergency=bool(emergency))
                else:
                    self.failures += 1
                    self.last_commit = {"path": path, "status": "failed",
                                        "error": err}
            if self._mon is not None:
                self._mon.emit(
                    "checkpoint", path=path, counter=int(counter),
                    status=status, error=err, emergency=bool(emergency),
                    async_write=self.async_, gather_ms=gather_ms,
                    **{k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in stats.items()})
            if status == "ok" and self.keep > 0 and self.model_dir:
                removed = retention_sweep(self.model_dir, self.keep)
                if removed and self._mon is not None:
                    self._mon.emit("checkpoint_gc", removed=len(removed),
                                   kept=self.keep, names=removed)

        if self.async_ and not emergency:
            self._writer.submit(_commit)
        else:
            # emergency snapshots commit inline: the process is about
            # to exit and must not race its own daemon writer
            self._writer.wait()
            _commit()
        self.last_save = {"gather_ms": gather_ms,
                          "save_ms": (time.perf_counter() - t0) * 1e3}

    def wait(self) -> None:
        """Block until the in-flight commit (if any) is durable."""
        self._writer.wait()

    def close(self) -> None:
        self._writer.wait()
