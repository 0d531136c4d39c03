"""Snapshot files: digest, atomic local write, verified read.

Counterpart of the snapshot core of ``cxxnet_tpu/nnet/checkpoint.py``:
the same npz of ``param/<layer>/<tag>`` and ``state/<layer>/<name>``
arrays plus a ``__meta__`` JSON record carrying ``format_version`` 2
and a ``content_digest`` (sha256 over every array's name, dtype, shape
and bytes). A snapshot written by either package loads in the other
with its digest verified.

Local paths only: the write goes to a ``.tmp`` sibling, is fsynced and
renamed over the final name, so a reader sees the old file or the new
one. Remote schemes, the async writer and resume scans are not ported.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
from typing import Any, Dict, Tuple

import numpy as np

from ..utils.stream import local_path, open_stream, read_stream_bytes

FORMAT_VERSION = 2


class SnapshotError(IOError):
    """Base for snapshot read failures."""


class SnapshotIntegrityError(SnapshotError):
    """Snapshot is unreadable, truncated, or fails its digest."""


class SnapshotFormatError(SnapshotError):
    """Snapshot was written by a newer format than this build reads."""


def compute_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Order-independent sha256 over every array's identity (name,
    dtype, shape) and bytes; ``__meta__`` is excluded."""
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


def write_snapshot(path: str, arrays: Dict[str, np.ndarray],
                   meta: Dict[str, Any]) -> str:
    """Serialize and atomically commit a snapshot to a local path;
    returns its content digest."""
    payload, digest = _serialize(arrays, meta)
    p = local_path(path)
    d = os.path.dirname(p)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = p + ".tmp"
    try:
        with open_stream(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    except BaseException:
        # the tmp sibling is garbage by definition; the commit failure
        # is what the caller must see
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return digest


def read_snapshot(path: str, verify: bool = True
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a snapshot into (arrays, meta). Raises
    :class:`SnapshotIntegrityError` on truncation, corruption or a
    digest mismatch and :class:`SnapshotFormatError` on a newer
    ``format_version``; a format-1 snapshot (no digest) loads with a
    warning."""
    try:
        raw = read_stream_bytes(path)
    except OSError as e:
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
    except ValueError as e:
        raise SnapshotIntegrityError(
            "snapshot %r has an unparseable __meta__: %s"
            % (path, e)) from e
    fv = int(meta.get("format_version", 1))
    if fv > FORMAT_VERSION:
        raise SnapshotFormatError(
            "snapshot %r was written by format_version %d but this "
            "build reads <= %d" % (path, fv, FORMAT_VERSION))
    if verify:
        digest = meta.get("content_digest")
        if digest:
            got = compute_digest(blob)
            if got != digest:
                raise SnapshotIntegrityError(
                    "snapshot %r fails its content digest (stored %s, "
                    "recomputed %s)" % (path, digest, got))
        else:
            print("cxxnet_tpu_torch: snapshot %r carries no content "
                  "digest (format_version %d); loading unverified"
                  % (path, fv), file=sys.stderr)
    return blob, meta
