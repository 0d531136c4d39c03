"""Offline snapshot/artifact integrity checker (counterpart of the
repo-root ``tools/ckpt_verify.py``, over the port's readers) — the
operator's first debugging step when a resume or artifact boot
misbehaves.

For each argument (a snapshot file, a sealed artifact bundle, or a
model_dir to scan — local path or remote URI, anything the stream
layer opens) it reports structural loadability, the content digest
verdict, the format version, and (remote) the commit-manifest
cross-check. Bundles additionally verify every member's sha256 (the
sealed programs included) and the snapshot inside::

    python -m cxxnet_tpu_torch.tools.ckpt_verify ./models
    python -m cxxnet_tpu_torch.tools.ckpt_verify memory://run7/0042.model.npz
    python -m cxxnet_tpu_torch.tools.ckpt_verify ./models/0042.model.bundle

Either package's snapshots and bundles verify (the formats are shared).
Exit status: 0 = every checked artifact verifies; 1 = at least one is
corrupt, truncated, digest-mismatched, or format-incompatible (an
empty model_dir is not corruption); 2 = usage error. An in-flight
``.tmp`` is never read or removed.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..artifact.bundle import (BUNDLE_RE, is_bundle, scan_bundles,
                               verify_bundle)
from ..nnet.checkpoint import (MODEL_RE, scan_snapshots, snapshot_uri,
                               verify_snapshot)
from ..utils.stream import list_stream_dir, stream_exists, uri_scheme


def _bundle_target(target: str) -> bool:
    """A target to verify as a bundle: any directory holding a
    manifest, or anything NAMED like a bundle — a vanished/tampered
    manifest on a ``NNNN.model.bundle`` path must report CORRUPT
    (exit 1), never fall through to an empty-dir all-clear."""
    if is_bundle(target):
        return True
    return bool(BUNDLE_RE.match(target.rstrip("/").rsplit("/", 1)[-1]))


def _is_dir(target: str) -> bool:
    if uri_scheme(target):
        # object stores have no real dirs: a URI whose basename looks
        # like a snapshot is ALWAYS checked as a file — a missing one
        # must report CORRUPT/unreadable (exit 1), never read as an
        # empty dir (exit 0, a false all-clear on a vanished
        # snapshot). Anything else is a dir unless it opens.
        if MODEL_RE.match(target.rsplit("/", 1)[-1]):
            return False
        return not stream_exists(target)
    return os.path.isdir(target)


def _check(path: str, quiet: bool) -> bool:
    rep = verify_snapshot(path)
    if rep["ok"]:
        if not quiet:
            print("OK       %s  (%d bytes, format v%d, digest %s)"
                  % (path, rep["bytes"], rep["format_version"],
                     rep["digest"]))
        return True
    print("CORRUPT  %s  (%s)" % (path, rep["error"]))
    return False


def _check_bundle(path: str, quiet: bool) -> bool:
    """Verify a sealed artifact bundle: commit marker, manifest sha,
    every member digest (programs included), and the snapshot
    inside — a tampered byte anywhere fails the whole bundle."""
    rep = verify_bundle(path)
    if rep["ok"]:
        if not quiet:
            print("OK       %s  (bundle, format v%d, %d members, "
                  "%d programs)"
                  % (path, rep["format_version"], rep["members"],
                     rep["programs"]))
        return True
    print("CORRUPT  %s  (bundle: %s)" % (path, rep["error"]))
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ckpt_verify",
        description="verify snapshot integrity (digest + structural "
                    "loadability), local or remote")
    ap.add_argument("targets", nargs="+",
                    help="snapshot files and/or model_dir paths/URIs")
    ap.add_argument("--quiet", action="store_true",
                    help="print corrupt snapshots only")
    args = ap.parse_args(argv)

    checked = 0
    bad = 0
    for target in args.targets:
        if _bundle_target(target):
            # an explicitly named bundle must verify commit marker
            # and all: an uncommitted one is a failure here (naming
            # it means you expect it deployable), unlike the
            # skip-and-report treatment inside a dir scan
            checked += 1
            if not _check_bundle(target, args.quiet):
                bad += 1
        elif _is_dir(target):
            names = [n for _, n in scan_snapshots(target)]
            bundles = [n for _, n in scan_bundles(target)]
            # uncommitted remote payloads (no .ok) are *reported* but
            # not counted as corruption: resume ignores them by design
            listing = set(list_stream_dir(target))
            if uri_scheme(target):
                for n in sorted(listing):
                    if MODEL_RE.match(n) and n + ".ok" not in listing:
                        print("UNCOMMITTED %s  (payload without "
                              "commit manifest; resume ignores it)"
                              % snapshot_uri(target, n))
            # uncommitted bundles likewise: the exporter may still be
            # writing them, and the hot-swap watcher skips them
            for n in sorted(listing):
                if BUNDLE_RE.match(n) and n not in bundles:
                    print("UNCOMMITTED %s  (bundle without commit "
                          "marker; the watcher ignores it)"
                          % snapshot_uri(target, n))
            if not names and not bundles and not args.quiet:
                print("EMPTY    %s  (no committed snapshots or "
                      "bundles)" % target)
            for n in names:
                checked += 1
                if not _check(snapshot_uri(target, n), args.quiet):
                    bad += 1
            for n in bundles:
                checked += 1
                if not _check_bundle(snapshot_uri(target, n),
                                     args.quiet):
                    bad += 1
        else:
            checked += 1
            if not _check(target, args.quiet):
                bad += 1
    if not args.quiet:
        print("checked %d snapshot(s), %d corrupt" % (checked, bad))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
