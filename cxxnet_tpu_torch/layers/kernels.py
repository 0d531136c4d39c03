"""Hand-written Hopper kernels of the port, with their plain versions.

Counterpart of ``cxxnet_tpu/layers/pallas_kernels.py``. Each kernel
here has

- its CUDA source under ``cxxnet_tpu_torch/csrc/``, compiled with
  ``nvcc`` for ``sm_90a`` into a plain-C shared library at first use
  (into ``cxxnet_tpu_torch/_build/``, named by the source's hash) and
  loaded with ``ctypes``;
- a plain PyTorch version of the same function, which the wrapper
  takes for tensors on the CPU and only for those: on a CUDA tensor
  the wrapper launches the kernel or raises;
- a launch counter on the wrapper (``wrapper.launches``), a plain int
  that only a kernel launch increments.

Ported so far: ``conv_epilogue`` (float input, forward).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

from ..utils.config import NotPortedError, Roadmap

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build of each source did: path, seconds, compiler log
build_info: Dict[str, Dict[str, object]] = {}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "cxxnet_tpu_torch build with nvcc at first use")


def build_kernel(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``_build/<name>-<hash>.so``
    unless that file exists, and return its path. The hash covers the
    source and the flags, so an edited source never loads a stale
    build."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest))
    if os.path.exists(so):
        build_info.setdefault(name, {"path": so, "seconds": 0.0,
                                     "log": "cached"})
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d" % (so, os.getpid())
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError("nvcc failed on %s (exit %d):\n%s%s"
                           % (src, res.returncode, res.stdout, res.stderr))
    os.replace(tmp, so)
    build_info[name] = {"path": so, "seconds": secs,
                        "log": (res.stdout + res.stderr).strip()}
    return so


def _load(name: str) -> ctypes.CDLL:
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_kernel(name))
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "conv_epilogue":
        fn = lib.cxn_conv_epilogue
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _cuda_error(code: int) -> str:
    try:
        rt = ctypes.CDLL("libcudart.so")
        rt.cudaGetErrorString.restype = ctypes.c_char_p
        rt.cudaGetErrorString.argtypes = [ctypes.c_int]
        return rt.cudaGetErrorString(code).decode()
    except OSError:
        return "cudaError %d" % code


# ------------------------------------------------------- conv epilogue


def conv_epilogue_plain(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, relu: bool,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """``relu?(float(x) * scale + shift)`` cast to ``out_dtype``: the
    plain PyTorch version of the conv_epilogue kernel."""
    y = x.float() * scale + shift
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def _check_epilogue(x, scale, shift, out_dtype) -> None:
    if x.dtype == torch.int32:
        raise NotPortedError("conv_epilogue on an int32 accumulator",
                             Roadmap.CONV_EPILOGUE_INT32)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("conv_epilogue: x must be float32 or bfloat16, "
                        "got %s" % x.dtype)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError("conv_epilogue: out_dtype must be float32 or "
                        "bfloat16, got %s" % out_dtype)
    if x.dim() not in (2, 4) or x.shape[-1] < 1:
        raise ValueError("conv_epilogue: x must be NHWC or (N, C), got "
                         "shape %s" % (tuple(x.shape),))
    c = x.shape[-1]
    for nm, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError("conv_epilogue: %s must be float32 of shape "
                             "(%d,), got %s %s"
                             % (nm, c, v.dtype, tuple(v.shape)))
        if v.device != x.device:
            raise ValueError("conv_epilogue: %s is on %s, x on %s"
                             % (nm, v.device, x.device))
    for nm, v in (("x", x), ("scale", scale), ("shift", shift)):
        if not v.is_contiguous():
            raise ValueError("conv_epilogue: %s must be contiguous "
                             "(the kernel reads a dense NHWC buffer)"
                             % nm)


def conv_epilogue(x: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, relu: bool,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``relu?(float(x) * scale + shift)`` per channel (last axis of a
    contiguous NHWC or (N, C) tensor), cast to ``out_dtype``: one
    launch of ``csrc/conv_epilogue.cu`` for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check_epilogue(x, scale, shift, out_dtype)
    if x.device.type == "cpu":
        return conv_epilogue_plain(x, scale, shift, relu, out_dtype)
    if x.device.type != "cuda":
        raise ValueError("conv_epilogue: no kernel for device %s"
                         % x.device)
    lib = _load("conv_epilogue")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cxn_conv_epilogue(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            x.numel(), x.shape[-1], _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out_dtype], int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError("conv_epilogue kernel launch failed: %s"
                           % _cuda_error(err))
    conv_epilogue.launches += 1
    return y


conv_epilogue.launches = 0


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counter."""
    conv_epilogue.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"conv_epilogue": conv_epilogue.launches}
