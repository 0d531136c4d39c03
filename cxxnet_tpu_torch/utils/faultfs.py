"""Fault-injection stream scheme: an in-memory filesystem that fails
on purpose (the port's copy of ``cxxnet_tpu/utils/faultfs.py``).

It registers a ``fault://`` (configurable) scheme through
``utils.stream.register_scheme`` and injects, under the caller's
control:

* **ENOSPC mid-write**: writes raise ``OSError(ENOSPC)`` once a file
  grows past ``enospc_after`` bytes;
* **torn writes**: the last ``truncate_tail`` bytes of a written file
  are dropped at close;
* **transient open/read failures**: the next ``fail_opens`` read opens
  (or ``fail_reads`` read() calls) raise IOError, then succeed;
* **targeted write failures**: opens-for-write whose URI contains
  ``fail_write_substr`` raise (``".ok"`` kills the commit manifest
  after the payload landed).

It implements the whole hook triple (opener, lister, remover), so the
resume scan and retention run against it end to end; a ``model_dir``
of ``fault://...`` in a config is a chaos drill.
"""

from __future__ import annotations

import errno
import io
from typing import Dict, Optional

from .stream import register_scheme


class _FaultWriteFile(io.BytesIO):
    """Write buffer that commits to the store on close (minus any
    injected torn tail) and enforces the ENOSPC budget per write()."""

    def __init__(self, fs: "FaultFS", uri: str):
        super().__init__()
        self._fs = fs
        self._uri = uri
        self._aborted = False

    def write(self, data) -> int:
        fs = self._fs
        if (fs.enospc_after is not None
                and self.tell() + len(data) > fs.enospc_after):
            self._aborted = True
            fs.counters["enospc"] += 1
            raise OSError(errno.ENOSPC, "faultfs: no space left on "
                          "device (enospc_after=%d)" % fs.enospc_after)
        return super().write(data)

    def close(self) -> None:
        if not self.closed and not self._aborted:
            data = self.getvalue()
            if self._fs.truncate_tail:
                data = data[:max(0, len(data) - self._fs.truncate_tail)]
                self._fs.counters["truncated"] += 1
            self._fs.store[self._uri] = data
        super().close()


class _FaultReadFile(io.BytesIO):
    def __init__(self, fs: "FaultFS", uri: str, data: bytes):
        super().__init__(data)
        self._fs = fs
        self._uri = uri

    def read(self, *args):
        fs = self._fs
        if fs.fail_reads > 0:
            fs.fail_reads -= 1
            fs.counters["read_fail"] += 1
            raise IOError("faultfs: injected transient read failure "
                          "on %r" % self._uri)
        return super().read(*args)


class FaultFS:
    """One in-memory store plus mutable fault knobs (see module doc).
    Construct, ``install()``, point URIs at ``<scheme>://...``."""

    def __init__(self, scheme: str = "fault"):
        self.scheme = scheme
        self.store: Dict[str, bytes] = {}
        # fault knobs — all off by default; tests flip them mid-run
        self.enospc_after: Optional[int] = None
        self.truncate_tail: int = 0
        self.fail_opens: int = 0
        self.fail_reads: int = 0
        self.fail_write_substr: str = ""
        self.counters = {"enospc": 0, "truncated": 0, "open_fail": 0,
                         "read_fail": 0}

    # -- stream hooks ----------------------------------------------------

    def open(self, uri: str, mode: str = "rb"):
        writing = any(c in mode for c in "wa+")
        if writing:
            if (self.fail_write_substr
                    and self.fail_write_substr in uri):
                self.counters["open_fail"] += 1
                raise IOError("faultfs: injected write failure on %r "
                              "(fail_write_substr=%r)"
                              % (uri, self.fail_write_substr))
            f = _FaultWriteFile(self, uri)
            return f if "b" in mode else io.TextIOWrapper(f)
        if self.fail_opens > 0:
            self.fail_opens -= 1
            self.counters["open_fail"] += 1
            raise IOError("faultfs: injected transient open failure "
                          "on %r" % uri)
        if uri not in self.store:
            raise FileNotFoundError(
                errno.ENOENT, "faultfs: no such object", uri)
        f = _FaultReadFile(self, uri, self.store[uri])
        return f if "b" in mode else io.TextIOWrapper(f)

    def list(self, dir_uri: str):
        prefix = dir_uri.rstrip("/") + "/"
        out = []
        for uri in self.store:
            if uri.startswith(prefix):
                rest = uri[len(prefix):]
                if "/" not in rest:
                    out.append(rest)
        return sorted(out)

    def remove(self, uri: str) -> None:
        del self.store[uri]

    # -- lifecycle -------------------------------------------------------

    def install(self) -> "FaultFS":
        register_scheme(self.scheme, self.open, lister=self.list,
                        remover=self.remove)
        return self

    def uninstall(self) -> None:
        register_scheme(self.scheme, None)

    def clear_faults(self) -> None:
        self.enospc_after = None
        self.truncate_tail = 0
        self.fail_opens = 0
        self.fail_reads = 0
        self.fail_write_substr = ""
