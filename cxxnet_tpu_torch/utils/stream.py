"""Local-path file streams: the part of the reference's ``open_stream``
(``cxxnet_tpu/utils/stream.py:172``) that the ported serving path uses.

Plain paths and ``file://`` URIs open with the builtin ``open``; write
opens create the parent directory. Any other scheme (``gs://``,
``memory://``, ...) raises :class:`NotPortedError`.
"""

import builtins
import os
import re

from .config import NotPortedError, Roadmap

# 2+ chars so Windows drive letters ('C://...') stay local
_URI_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]+)://")


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


def open_stream(uri: str, mode: str = "rb"):
    """Open a local path for reading or writing."""
    scheme = uri_scheme(uri)
    if scheme:
        raise NotPortedError("%s:// streams" % scheme,
                             Roadmap.CHECKPOINT_CLI)
    path = local_path(uri)
    if any(c in mode for c in "wa+"):
        d = os.path.dirname(path)
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)
    return builtins.open(path, mode)


def read_stream_bytes(uri: str) -> bytes:
    """The full contents of a local path."""
    with open_stream(uri, "rb") as f:
        return f.read()


def stream_exists(uri: str) -> bool:
    """Whether a local path exists."""
    scheme = uri_scheme(uri)
    if scheme:
        raise NotPortedError("%s:// streams" % scheme,
                             Roadmap.CHECKPOINT_CLI)
    return os.path.exists(local_path(uri))
