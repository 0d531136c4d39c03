"""Sealed model artifacts: a verified snapshot and its programs
(counterpart of ``cxxnet_tpu/artifact/bundle.py``).

A *bundle* is the deployable unit ``task = export`` writes and a serve
replica boots from. Its on-disk format is the reference's, unchanged:
one directory holding

- ``snapshot.model.npz`` — a verified snapshot (digest, ``quant/``
  arrays included), re-committed under the bundle so the bundle is
  self-contained;
- ``prog-NNNN.pkl`` — one program member per key, keyed in the
  manifest by the key's ``repr``. In a port bundle each is a kernel
  library the frozen serve path loads (``artifact/registry.py``: the
  library-as-program rule); in the reference's, a pickled JAX
  executable, which the port never unpickles;
- ``index.embed.npz`` — with ``task = build_index`` (or a continual
  generation with ``continual_index_rows``), the embedding index
  (``retrieval/index.py``), and the manifest's ``index`` block (shape,
  metric, node, the search depth ``k`` and query ``buckets``);
- ``MANIFEST.json`` — format version 1, the runtime fingerprint
  (``artifact/fingerprint.py``: backend ``torch`` here), the bucket
  ladder and serve dtype the programs were sealed for, and a (name,
  bytes, sha256) row for every member;
- ``MANIFEST.json.ok`` — the commit marker (manifest bytes and
  file_sha256), written last, after a directory fsync. A bundle without
  it is uncommitted: the hot-swap watcher does not see it.

So the reference's ``verify_bundle`` and ``load_bundle`` accept a
bundle the port writes, and the port's accept one the reference
writes. The two fingerprints never agree, so a bundle that crosses
packages boots through the rebuild path: one
``artifact_fingerprint_mismatch`` warning, ``hits`` 0, ``rebuilds ==
len(programs)``, and the same rows as its snapshot.

Everything goes through ``utils/stream.py``, so bundles work on local
paths, remote URIs and the ``fault://`` scheme.

Exporting ``NNNN.model.npz`` defaults to ``NNNN.model.bundle`` beside
it, so a watched ``model_dir`` can carry both, and the watcher prefers
the bundle at equal counters.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any, Dict, List, Tuple

from ..utils.stream import (list_stream_dir, local_path, open_stream,
                            read_stream_bytes, remove_stream,
                            stream_exists, uri_scheme)
from .fingerprint import runtime_fingerprint
from .registry import parse_key

BUNDLE_FORMAT_VERSION = 1
BUNDLE_KIND = "cxxnet_artifact_bundle"
MANIFEST_NAME = "MANIFEST.json"
OK_SUFFIX = ".ok"
SNAPSHOT_MEMBER = "snapshot.model.npz"
# the sealed embedding index member (a re-export sweeps it like a
# program member); the same name as retrieval.index.INDEX_MEMBER
INDEX_MEMBER = "index.embed.npz"

BUNDLE_RE = re.compile(r"^(\d{4})\.model\.bundle$")
_PROG_RE = re.compile(r"^prog-\d{4}\.pkl$")

_MANIFEST_REQUIRED = ("format_version", "kind", "fingerprint",
                      "buckets", "serve_dtype", "snapshot", "members",
                      "programs")


class BundleError(IOError):
    """Bundle is unreadable, uncommitted, tampered, or malformed."""


def member_uri(bundle: str, name: str) -> str:
    """URI of one member inside a bundle directory: the snapshot path
    join (``checkpoint.snapshot_uri``)."""
    from ..nnet.checkpoint import snapshot_uri
    return snapshot_uri(bundle, name)


def _commit_member(uri: str, data: bytes) -> None:
    """Durably write one bundle member: a local path through a tmp file,
    fsync and rename; a remote scheme through the stream layer."""
    if uri_scheme(uri):
        with open_stream(uri, "wb") as f:
            f.write(data)
        return
    p = local_path(uri)
    d = os.path.dirname(p)
    if d and not os.path.isdir(d):
        os.makedirs(d, exist_ok=True)
    tmp = p + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass    # best effort; the write failure is what the caller sees
        raise


def _fsync_dir(bundle: str) -> None:
    """Make the bundle directory's entries durable before (and after)
    the commit marker; a refusal warns once."""
    if uri_scheme(bundle):
        return
    d = local_path(bundle)
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError as e:
        from ..monitor import warn_once
        warn_once("dir_fsync_refused",
                  "directory fsync of %r failed (%s); the bundle "
                  "commit is not guaranteed durable across power "
                  "loss on this filesystem" % (d, e))


def is_bundle(path: str) -> bool:
    """True when ``path`` is a bundle directory (committed or not)."""
    if not uri_scheme(path) and not os.path.isdir(local_path(path)):
        return False
    return stream_exists(member_uri(path, MANIFEST_NAME))


def default_bundle_path(model_in: str) -> str:
    """``NNNN.model.npz`` -> ``NNNN.model.bundle`` beside it; a bundle
    ``model_in`` re-exports in place; any other name gets ``.bundle``
    after its ``.npz`` is stripped."""
    if model_in.rstrip("/").endswith(".bundle"):
        return model_in.rstrip("/")
    if model_in.endswith(".model.npz"):
        return model_in[:-len(".npz")] + ".bundle"
    return re.sub(r"\.npz$", "", model_in) + ".bundle"


# -- export ---------------------------------------------------------------


def export_bundle(engine, out: str, node: str = "",
                  monitor=None, retrieval=None) -> Dict[str, Any]:
    """Seal a warmed engine into a committed bundle at ``out``: its
    trainer's weights and the kernel libraries its serve path loaded.
    ``retrieval`` (a warmed
    :class:`~cxxnet_tpu_torch.retrieval.engine.RetrievalEngine`, or
    None) also seals its embedding index and its search contract, so
    model and index commit, verify and hot-swap as one artifact; the
    search runs no hand-written kernel, so it seals no program.

    Write order is the commit protocol: a stale ``.ok`` and the program
    members of an earlier export at the same path go first, then the
    members (each committed through :func:`_commit_member`), the
    manifest, a directory fsync, and ``MANIFEST.json.ok`` last. A crash
    at any point leaves an uncommitted bundle, never a torn committed
    one. Returns the ``export`` record fields."""
    from ..monitor import config_hash
    from ..nnet.checkpoint import _serialize
    t0 = time.perf_counter()
    trainer = engine.trainer
    # installed libraries ship the source bundle's bytes, read before
    # anything below overwrites it (a bundle model_in re-exports in
    # place)
    passthrough = _source_blobs(trainer.programs, monitor)
    ok_uri = member_uri(out, MANIFEST_NAME + OK_SUFFIX)
    if stream_exists(ok_uri) and not remove_stream(ok_uri):
        raise BundleError(
            "cannot drop the stale commit marker %s; refusing to "
            "re-export over a committed bundle" % ok_uri)
    for name in list_stream_dir(out):
        if _PROG_RE.match(name) or name == INDEX_MEMBER:
            remove_stream(member_uri(out, name))
    arrays, meta = trainer.gather_snapshot()
    payload, digest = _serialize(arrays, meta)
    _commit_member(member_uri(out, SNAPSHOT_MEMBER), payload)
    members: List[Dict[str, Any]] = [{
        "name": SNAPSHOT_MEMBER, "bytes": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest(),
    }]
    programs: List[Dict[str, str]] = []
    total = len(payload)
    blobs = passthrough + trainer.programs.serialize(monitor=monitor)
    for i, (key, blob) in enumerate(sorted(blobs,
                                           key=lambda e: repr(e[0]))):
        name = "prog-%04d.pkl" % i
        _commit_member(member_uri(out, name), blob)
        members.append({"name": name, "bytes": len(blob),
                        "sha256": hashlib.sha256(blob).hexdigest()})
        programs.append({"name": name, "key": repr(key)})
        total += len(blob)
    index_entry = None
    if retrieval is not None:
        idx_blob = retrieval.index.serialize()
        index_entry = retrieval.index.manifest_entry()
        # the served search contract, so a boot serves what was sealed
        index_entry.update({"k": int(retrieval.k),
                            "buckets": [int(b)
                                        for b in retrieval.buckets]})
        _commit_member(member_uri(out, index_entry["member"]), idx_blob)
        members.append({
            "name": index_entry["member"], "bytes": len(idx_blob),
            "sha256": hashlib.sha256(idx_blob).hexdigest()})
        total += len(idx_blob)
    manifest = {
        "format_version": BUNDLE_FORMAT_VERSION,
        "kind": BUNDLE_KIND,
        "fingerprint": runtime_fingerprint(trainer.device),
        "buckets": [int(b) for b in engine.buckets],
        "nodes": [int(n) for n in engine.nodes],
        "node": node,
        "serve_dtype": trainer.serve_dtype,
        "input_dtype": str(engine.input_dtype).replace("torch.", ""),
        # 1: the serve path reads the frozen serve tree
        # (trainer.freeze_serve_weights); 0: the raw masters
        "weight_residency": int(bool(trainer.serve_weight_residency)),
        "config_hash": config_hash(trainer.cfg),
        "content_digest": digest,
        "snapshot": SNAPSHOT_MEMBER,
        "members": members,
        "programs": programs,
    }
    if index_entry is not None:
        manifest["index"] = index_entry
    man_bytes = json.dumps(manifest, sort_keys=True, indent=1).encode()
    _commit_member(member_uri(out, MANIFEST_NAME), man_bytes)
    _fsync_dir(out)
    marker = {"format_version": BUNDLE_FORMAT_VERSION,
              "bytes": len(man_bytes),
              "file_sha256": hashlib.sha256(man_bytes).hexdigest()}
    _commit_member(ok_uri, json.dumps(marker).encode())
    _fsync_dir(out)
    return {
        "out": out,
        "snapshot": digest,
        "programs": len(programs),
        "members": len(members),
        "bytes": total + len(man_bytes),
        "wall_ms": (time.perf_counter() - t0) * 1e3,
    }


def _source_blobs(store, monitor) -> List[Tuple[tuple, bytes]]:
    """The original member bytes of the store's installed keys, read
    back from the bundle they came from. A source that has since
    vanished warns, and the re-export ships without those keys (a boot
    then rebuilds them)."""
    if not store.installed or not store.bundle_path:
        return []
    out: List[Tuple[tuple, bytes]] = []
    try:
        man = bundle_manifest(store.bundle_path)
        name_by_key = {p["key"]: p["name"] for p in man["programs"]}
        for key in sorted(store.installed, key=repr):
            name = name_by_key.get(repr(key))
            if name is None:
                continue
            out.append((key, read_stream_bytes(
                member_uri(store.bundle_path, name))))
    except (BundleError, IOError, OSError) as e:
        from .registry import _warn
        _warn(monitor, "artifact_source_unreadable",
              "source bundle %s is no longer readable (%s); re-export "
              "ships without its %d installed program(s)"
              % (store.bundle_path, e, len(store.installed)))
        return []
    return out


# -- verify ---------------------------------------------------------------


def verify_bundle(path: str) -> Dict[str, Any]:
    """Offline integrity report for one bundle: commit marker, manifest
    bytes and sha, manifest schema, every member's size and sha256, and
    the snapshot's own content digest. ``ok`` is True only when every
    check passes; the first failure names itself in ``error``. Never
    raises for a malformed bundle."""
    rep: Dict[str, Any] = {"path": path, "ok": False, "error": "",
                           "members": 0, "programs": 0,
                           "format_version": 0, "committed": False}
    rep["committed"] = stream_exists(
        member_uri(path, MANIFEST_NAME + OK_SUFFIX))
    try:
        manifest, _ = _read_manifest(path)
    except BundleError as e:
        rep["error"] = str(e)
        return rep
    rep["format_version"] = int(manifest["format_version"])
    rep["programs"] = len(manifest["programs"])
    for m in manifest["members"]:
        rep["members"] += 1
        uri = member_uri(path, m["name"])
        try:
            data = read_stream_bytes(uri)
        except (IOError, OSError) as e:
            rep["error"] = "member %s unreadable: %s" % (m["name"], e)
            return rep
        if len(data) != m.get("bytes"):
            rep["error"] = ("member %s size mismatch: manifest says "
                            "%s bytes, found %d"
                            % (m["name"], m.get("bytes"), len(data)))
            return rep
        if hashlib.sha256(data).hexdigest() != m.get("sha256"):
            rep["error"] = "member %s fails its sha256" % m["name"]
            return rep
    from ..nnet.checkpoint import verify_snapshot
    snap_rep = verify_snapshot(member_uri(path, manifest["snapshot"]))
    if not snap_rep["ok"]:
        rep["error"] = "snapshot member: %s" % snap_rep["error"]
        return rep
    rep["ok"] = True
    return rep


def _manifest_malformed(manifest) -> str:
    """Structural validation of a parsed manifest: tampered but
    parseable JSON of any shape gives a verdict string, never an
    attribute or key error. "" when well-formed."""
    if not isinstance(manifest, dict):
        return "manifest is not a JSON object"
    if manifest.get("kind") != BUNDLE_KIND:
        return "not a %s manifest" % BUNDLE_KIND
    missing = [k for k in _MANIFEST_REQUIRED if k not in manifest]
    if missing:
        return ("manifest missing required field(s): %s"
                % ", ".join(missing))
    if not isinstance(manifest["format_version"], int):
        return "manifest format_version is not an integer"
    if not isinstance(manifest["snapshot"], str):
        return "manifest snapshot field is not a member name"
    if not isinstance(manifest["fingerprint"], dict):
        return "manifest fingerprint is not an object"
    if not isinstance(manifest["serve_dtype"], str):
        return "manifest serve_dtype is not a string"
    buckets = manifest["buckets"]
    if not isinstance(buckets, list) or not buckets \
            or any(not isinstance(b, int) or b < 1 for b in buckets):
        return "manifest buckets is not a non-empty list of positive " \
               "ints"
    for field, keys in (("members", (("name", str), ("bytes", int),
                                     ("sha256", str))),
                        ("programs", (("name", str), ("key", str)))):
        rows = manifest[field]
        if not isinstance(rows, list):
            return "manifest %s is not a list" % field
        for m in rows:
            if not isinstance(m, dict) \
                    or any(not isinstance(m.get(k), t)
                           for k, t in keys):
                return "manifest %s row is malformed: %r" % (field, m)
    # everything the bundle claims to contain must be covered by a
    # members row
    names = {m["name"] for m in manifest["members"]}
    if manifest["snapshot"] not in names:
        return ("manifest snapshot %r has no members row"
                % manifest["snapshot"])
    for p in manifest["programs"]:
        if p["name"] not in names:
            return "manifest program %r has no members row" % p["name"]
    idx = manifest.get("index")
    if idx is not None:
        if not isinstance(idx, dict):
            return "manifest index is not an object"
        for k, t in (("member", str), ("metric", str), ("node", str),
                     ("rows", int), ("dim", int), ("k", int)):
            if not isinstance(idx.get(k), t):
                return "manifest index field %r is malformed" % k
        ibuckets = idx.get("buckets")
        if not isinstance(ibuckets, list) or not ibuckets \
                or any(not isinstance(b, int) or b < 1
                       for b in ibuckets):
            return "manifest index buckets is not a non-empty list " \
                   "of positive ints"
        if idx["member"] not in names:
            return ("manifest index member %r has no members row"
                    % idx["member"])
    return ""


def _read_manifest(path: str) -> Tuple[Dict[str, Any], bytes]:
    """The one committed-manifest reader behind ``bundle_manifest``,
    ``verify_bundle`` and ``load_bundle``: the commit marker, its
    shape, the manifest bytes and sha, the structure, the format gate.
    Raises :class:`BundleError`; returns (manifest, manifest bytes)."""
    man_uri = member_uri(path, MANIFEST_NAME)
    ok_uri = man_uri + OK_SUFFIX
    if not stream_exists(ok_uri):
        raise BundleError("uncommitted bundle %s (no %s%s commit "
                          "marker)" % (path, MANIFEST_NAME, OK_SUFFIX))
    try:
        marker = json.loads(read_stream_bytes(ok_uri).decode())
        man_bytes = read_stream_bytes(man_uri)
    except (IOError, OSError, ValueError) as e:
        raise BundleError("bundle %s manifest/commit marker "
                          "unreadable: %s" % (path, e)) from e
    if not isinstance(marker, dict):
        raise BundleError("bundle %s commit marker is not a JSON "
                          "object" % path)
    if marker.get("bytes") != len(man_bytes):
        raise BundleError(
            "bundle %s manifest size mismatch: committed %s bytes, "
            "found %d" % (path, marker.get("bytes"), len(man_bytes)))
    # file_sha256 is required: a consistently rewritten marker and
    # manifest must not pass
    if marker.get("file_sha256") \
            != hashlib.sha256(man_bytes).hexdigest():
        raise BundleError("bundle %s manifest file_sha256 missing or "
                          "mismatched" % path)
    try:
        manifest = json.loads(man_bytes.decode())
    except ValueError as e:
        raise BundleError("bundle %s manifest unparseable: %s"
                          % (path, e)) from e
    err = _manifest_malformed(manifest)
    if err:
        raise BundleError("bundle %s: %s" % (path, err))
    if int(manifest["format_version"]) > BUNDLE_FORMAT_VERSION:
        raise BundleError(
            "bundle %s format_version %d is newer than this build "
            "reads (<= %d); upgrade cxxnet_tpu or re-export"
            % (path, manifest["format_version"],
               BUNDLE_FORMAT_VERSION))
    return manifest, man_bytes


# -- load -----------------------------------------------------------------


class Bundle:
    """A verified, parsed bundle ready to attach to a trainer:
    ``snapshot_raw`` holds the inner snapshot's verified bytes (the
    load never reads them again), ``programs`` the digest-checked
    (key, member bytes) pairs, which only ``ProgramStore.install``
    reads, and only as kernel libraries."""

    __slots__ = ("path", "manifest", "snapshot_uri", "snapshot_raw",
                 "programs")

    def __init__(self, path: str, manifest: Dict[str, Any],
                 snapshot_raw: bytes,
                 programs: List[Tuple[tuple, bytes]]):
        self.path = path
        self.manifest = manifest
        self.snapshot_uri = member_uri(path, manifest["snapshot"])
        self.snapshot_raw = snapshot_raw
        self.programs = programs


def bundle_manifest(path: str) -> Dict[str, Any]:
    """A bundle's committed manifest (marker cross-checked, structure
    validated) without the per-member verification. Raises
    BundleError."""
    return _read_manifest(path)[0]


def load_bundle(path: str) -> Bundle:
    """Verify and load a bundle in one pass over its members: each is
    read once, its size and sha256 checked, the snapshot's bytes and
    the program members kept. Raises :class:`BundleError` on any
    integrity failure."""
    manifest, _ = _read_manifest(path)
    blobs: Dict[str, bytes] = {}
    for m in manifest["members"]:
        uri = member_uri(path, m["name"])
        try:
            data = read_stream_bytes(uri)
        except (IOError, OSError) as e:
            raise BundleError("bundle %s member %s unreadable: %s"
                              % (path, m["name"], e)) from e
        if len(data) != m["bytes"] \
                or hashlib.sha256(data).hexdigest() != m["sha256"]:
            raise BundleError(
                "bundle %s member %s fails verification (size/sha256 "
                "mismatch)" % (path, m["name"]))
        blobs[m["name"]] = data
    programs: List[Tuple[tuple, bytes]] = []
    for p in manifest["programs"]:
        try:
            key = parse_key(p["key"])
        except (ValueError, SyntaxError) as e:
            raise BundleError(
                "bundle %s program key %r is unparseable: %s"
                % (path, p.get("key"), e)) from e
        programs.append((key, blobs[p["name"]]))
    return Bundle(path, manifest, blobs[manifest["snapshot"]],
                  programs)


def read_index_member(path: str, manifest: Dict[str, Any] = None
                      ) -> bytes:
    """Digest-verified bytes of a bundle's sealed embedding index, or
    ``b""`` when it seals none. A missing or torn member raises
    :class:`BundleError`."""
    man = bundle_manifest(path) if manifest is None else manifest
    idx = man.get("index")
    if idx is None:
        return b""
    row = next(m for m in man["members"] if m["name"] == idx["member"])
    try:
        data = read_stream_bytes(member_uri(path, idx["member"]))
    except (IOError, OSError) as e:
        raise BundleError("bundle %s index member %s unreadable: %s"
                          % (path, idx["member"], e)) from e
    if len(data) != row["bytes"] \
            or hashlib.sha256(data).hexdigest() != row["sha256"]:
        raise BundleError(
            "bundle %s index member %s fails verification (size/"
            "sha256 mismatch)" % (path, idx["member"]))
    return data


def serve_cfg_from_bundle(path: str) -> List[Tuple[str, str]]:
    """Config pairs a conf-less boot derives from the manifest: the
    sealed bucket ladder, serve dtype, weight residency and node. Put
    them first, so that an explicit config still wins."""
    man = bundle_manifest(path)
    pairs = [
        ("serve_buckets", ",".join(str(b) for b in man["buckets"])),
        ("serve_max_batch", str(max(man["buckets"]))),
        ("serve_dtype", man["serve_dtype"]),
    ]
    if "weight_residency" in man:
        pairs.append(("serve_weight_residency",
                      str(int(man["weight_residency"]))))
    if man.get("node"):
        pairs.append(("serve_node", man["node"]))
    return pairs


# -- model_dir scan -------------------------------------------------------


def scan_bundles(model_dir: str) -> List[Tuple[int, str]]:
    """Committed bundle candidates in ``model_dir`` as (counter,
    basename), newest first. Uncommitted bundles (no ``.ok``) are left
    out: the export may still be writing them. Read-only."""
    out = []
    for n in list_stream_dir(model_dir):
        m = BUNDLE_RE.match(n)
        if not m:
            continue
        b = member_uri(model_dir, n)
        if not stream_exists(member_uri(b, MANIFEST_NAME + OK_SUFFIX)):
            continue
        out.append((int(m.group(1)), n))
    out.sort(reverse=True)
    return out
