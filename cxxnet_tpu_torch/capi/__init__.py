"""The port's C ABI (``cxxnet_wrapper.h`` / ``cxxnet_wrapper.cc`` here):
the reference's ``CXNIO*`` / ``CXNNet*`` entry points over
:mod:`cxxnet_tpu_torch.wrapper`, for C and Matlab hosts.

:func:`build_library` compiles ``cxxnet_wrapper.cc`` with ``g++``
against the running interpreter's headers and libpython into
``cxxnet_tpu_torch/_build/libcxxnet_wrapper.so``, at first use and again
whenever the sources, the flags or the interpreter change. A host links
it as ``-L<_build> -lcxxnet_wrapper`` (with ``-I`` at this directory, or
at ``wrapper/``: the two headers declare the same entry points), e.g.
``wrapper/matlab/mex_driver.cc`` with the stub::

    g++ -std=c++17 -Iwrapper/matlab/mex_stub -o mex_driver \\
        wrapper/matlab/mex_driver.cc wrapper/matlab/cxxnet_mex.cpp \\
        wrapper/matlab/mex_stub/mex_stub.cc \\
        -L<_build> -Wl,-rpath,<_build> -lcxxnet_wrapper

From Python, ``ctypes.CDLL(build_library())`` loads it into the live
interpreter (it then only takes the GIL).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import List

CAPI_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CAPI_DIR), "_build")
LIB_NAME = "libcxxnet_wrapper.so"
SOURCES = ("cxxnet_wrapper.cc", "cxxnet_wrapper.h")

_build_lock = threading.Lock()


def library_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def compile_command(out: str) -> List[str]:
    """The ``g++`` command that builds the library into ``out``."""
    cfg = sysconfig.get_config_var
    include = sysconfig.get_paths()["include"]
    libdir = cfg("LIBDIR") or ""
    ldver = cfg("LDVERSION") or "%d.%d" % sys.version_info[:2]
    exe = sys.executable.replace("\\", "\\\\").replace('"', '\\"')
    return ["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-shared",
            "-I" + include, "-I" + CAPI_DIR,
            '-DCXN_PYTHON_EXECUTABLE="%s"' % exe,
            "-o", out, os.path.join(CAPI_DIR, "cxxnet_wrapper.cc"),
            "-L" + libdir, "-Wl,-rpath," + libdir,
            "-lpython" + ldver, "-ldl"]


def _stamp() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CAPI_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(compile_command("-")).encode())
    return h.hexdigest()


def build_library() -> str:
    """Build (if needed) and return the path of
    ``_build/libcxxnet_wrapper.so``. Raises RuntimeError with the
    compiler's output when the build fails (a missing ``Python.h``
    among the causes); there is no other library to fall back to."""
    with _build_lock:
        so = library_path()
        stamp_path = so + ".stamp"
        stamp = _stamp()
        if os.path.exists(so) and os.path.exists(stamp_path):
            with open(stamp_path) as f:
                if f.read() == stamp:
                    return so
        if shutil.which("g++") is None:
            raise RuntimeError("building %s needs g++, which is not on "
                               "PATH" % LIB_NAME)
        include = sysconfig.get_paths()["include"]
        if not os.path.exists(os.path.join(include, "Python.h")):
            raise RuntimeError(
                "building %s needs Python.h, which is not in %s (the "
                "interpreter's development headers are missing)"
                % (LIB_NAME, include))
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.tmp%d" % (so, os.getpid())
        proc = subprocess.run(compile_command(tmp),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed to build %s (exit %d):\n%s"
                               % (LIB_NAME, proc.returncode, proc.stdout))
        os.replace(tmp, so)
        with open(stamp_path, "w") as f:
            f.write(stamp)
        return so
