"""URI-addressed file streams: every open of the port goes through
:func:`open_stream` (counterpart of ``cxxnet_tpu/utils/stream.py``).

- plain local paths (and ``file://``) use the builtin ``open``; write
  opens create the parent directory;
- a ``scheme://`` URI goes to the opener registered for its scheme
  (:func:`register_scheme`; the ``fault://`` scheme of
  ``utils/faultfs.py`` is one), else through ``fsspec``, imported at
  the open; without fsspec the open raises ``IOError`` naming the
  scheme.

``set_stream_retry`` turns on exponential-backoff retries for *read*
opens of scheme URIs (the ``stream_retry`` key); writers never retry,
since the checkpoint layer owns what a failed write means.
"""

import builtins
import os
import random
import re
import time
from typing import Callable, Dict, Optional

from ..monitor import get_global, warn_once

# 2+ chars so Windows drive letters ('C://...') stay local
_URI_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]+)://")


class _SchemeHooks:
    """Handlers of one scheme: ``opener(uri, mode)`` is required;
    ``lister(dir_uri) -> [basenames]`` and ``remover(uri)`` are optional
    (without them a directory lists empty and a delete is skipped)."""

    __slots__ = ("opener", "lister", "remover")

    def __init__(self, opener: Callable,
                 lister: Optional[Callable] = None,
                 remover: Optional[Callable] = None):
        self.opener = opener
        self.lister = lister
        self.remover = remover


# scheme -> hooks; openers receive the full uri, scheme included
_SCHEMES: Dict[str, _SchemeHooks] = {}

# opt-in retry policy for transient remote-read failures (stream_retry)
_RETRY = {"attempts": 0, "base_ms": 50.0, "max_ms": 2000.0}
_RETRY_RECOVERED = 0       # process-lifetime count of retried-then-ok ops


def register_scheme(scheme: str, opener: Optional[Callable],
                    lister: Optional[Callable] = None,
                    remover: Optional[Callable] = None) -> None:
    """Register ``opener(uri, mode) -> file-like`` for ``scheme://``
    URIs (it wins over fsspec); ``opener=None`` unregisters.
    ``lister`` serves :func:`list_stream_dir` (the resume scan) and
    ``remover`` :func:`remove_stream` (retention)."""
    if opener is None:
        _SCHEMES.pop(scheme, None)
    else:
        _SCHEMES[scheme] = _SchemeHooks(opener, lister, remover)


def set_stream_retry(attempts: int, base_ms: float = 50.0,
                     max_ms: float = 2000.0) -> None:
    """Retry transient remote read failures ``attempts`` times (0: off)
    with backoff ``base_ms * 2^k`` capped at ``max_ms`` and jitter in
    [0.5, 1.5)x. Local paths never retry."""
    _RETRY["attempts"] = max(0, int(attempts))
    _RETRY["base_ms"] = float(base_ms)
    _RETRY["max_ms"] = float(max_ms)


def stream_retry_count() -> int:
    """Operations that failed transiently and then succeeded on retry,
    over the process's life."""
    return _RETRY_RECOVERED


def _retrying(fn: Callable, uri: str, what: str):
    """``fn()`` under the retry policy; a success after a failure warns
    once and emits a ``stream_retry`` record into the run's stream."""
    attempts = _RETRY["attempts"]
    if attempts <= 0:
        return fn()
    tries = 0
    while True:
        try:
            out = fn()
        except OSError:
            tries += 1
            if tries > attempts:
                raise
            delay = min(_RETRY["max_ms"],
                        _RETRY["base_ms"] * (2 ** (tries - 1))) / 1e3
            time.sleep(delay * (0.5 + random.random()))
            continue
        if tries:
            global _RETRY_RECOVERED
            _RETRY_RECOVERED += 1
            warn_once("stream_retry",
                      "transient %s failure on %r recovered after %d "
                      "retr%s (stream_retry=%d)"
                      % (what, uri, tries, "y" if tries == 1 else "ies",
                         attempts))
            mon = get_global()
            if mon is not None and mon.enabled:
                mon.emit("stream_retry", uri=uri, what=what,
                         attempts=tries)
        return out


def uri_scheme(uri: str) -> str:
    """The URI scheme, or '' for a plain local path ('file' counts as
    local)."""
    m = _URI_RE.match(uri)
    if m is None:
        return ""
    s = m.group(1).lower()
    return "" if s == "file" else s


def local_path(uri: str) -> str:
    """Strip a 'file://' prefix; other paths pass through."""
    return uri[7:] if uri.lower().startswith("file://") else uri


def _open_raw(uri: str, mode: str):
    scheme = uri_scheme(uri)
    if scheme == "":
        path = local_path(uri)
        if any(c in mode for c in "wa+"):
            d = os.path.dirname(path)
            if d and not os.path.isdir(d):
                os.makedirs(d, exist_ok=True)
        return builtins.open(path, mode)
    if scheme in _SCHEMES:
        return _SCHEMES[scheme].opener(uri, mode)
    try:
        import fsspec
        return fsspec.open(uri, mode).open()
    except (ImportError, ValueError) as e:
        raise IOError(
            "open_stream: no handler for scheme '%s://' (uri=%r): %s. "
            "Install fsspec (plus the %s filesystem package) or "
            "register_scheme('%s', opener)." % (scheme, uri, e, scheme,
                                                scheme))


def open_stream(uri: str, mode: str = "rb"):
    """Open ``uri`` for reading or writing; a file-like object. Read
    opens of scheme URIs follow :func:`set_stream_retry`."""
    if uri_scheme(uri) and not any(c in mode for c in "wa+"):
        return _retrying(lambda: _open_raw(uri, mode), uri, "open")
    return _open_raw(uri, mode)


def read_stream_bytes(uri: str) -> bytes:
    """The full contents of ``uri``. For a scheme URI the open and the
    read are one retried unit: the caller gets every byte or an
    exception, never a torn prefix."""
    def _do():
        with _open_raw(uri, "rb") as f:
            return f.read()
    if uri_scheme(uri):
        return _retrying(_do, uri, "read")
    return _do()


def list_stream_dir(uri: str):
    """Entry basenames of a directory URI; [] where it does not exist,
    or where a registered scheme has no lister. A transient remote
    error propagates: read as an empty directory it would restart a
    ``continue = 1`` run from round 0."""
    scheme = uri_scheme(uri)
    if scheme == "":
        path = local_path(uri)
        if not os.path.isdir(path):
            return []
        return os.listdir(path)
    if scheme in _SCHEMES:
        hooks = _SCHEMES[scheme]
        if hooks.lister is None:
            return []
        return list(hooks.lister(uri))
    try:
        import fsspec
        fs, root = fsspec.core.url_to_fs(uri)
        return [p.rstrip("/").rsplit("/", 1)[-1]
                for p in fs.ls(root, detail=False)]
    except FileNotFoundError:
        return []
    except (ImportError, ValueError):
        return []


def remove_stream(uri: str) -> bool:
    """Delete ``uri``; True on success, False when it is missing or the
    scheme has no remover. Never raises: a failed delete must not end a
    training run."""
    scheme = uri_scheme(uri)
    if scheme == "":
        try:
            os.remove(local_path(uri))
            return True
        except OSError:
            return False
    if scheme in _SCHEMES:
        hooks = _SCHEMES[scheme]
        if hooks.remover is None:
            return False
        try:
            hooks.remover(uri)
            return True
        except (OSError, KeyError):
            return False
    try:
        import fsspec
        fs, root = fsspec.core.url_to_fs(uri)
        fs.rm(root)
        return True
    except Exception:
        return False


def stream_exists(uri: str) -> bool:
    """Whether ``uri`` names an existing file (a local stat, or a remote
    open that succeeds)."""
    if uri_scheme(uri) == "":
        return os.path.exists(local_path(uri))
    try:
        with _open_raw(uri, "rb"):
            return True
    except OSError:
        return False
