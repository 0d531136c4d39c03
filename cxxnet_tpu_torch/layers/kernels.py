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

Ported so far:

- ``conv_epilogue`` (float input, forward);
- ``bn_apply`` forward and backward (``bn_apply_fwd`` /
  ``bn_apply_bwd``), differentiable as :func:`bn_apply`;
- ``matmul``, differentiable as :func:`matmul`: the forward and both
  backward products run through the kernel;
- ``relu_max_pool`` forward and backward (``relu_max_pool_fwd`` /
  ``relu_max_pool_bwd``), differentiable as :func:`relu_max_pool`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils.config import NotPortedError, Roadmap

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNEL_SOURCES = ("conv_epilogue", "bn_apply", "matmul", "relu_max_pool")

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


def _so_path(name: str) -> Tuple[str, str]:
    """(source, shared library) of a kernel. The library's name hashes
    the source and the flags, so an edited source never loads a stale
    build."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest))


def build_kernels(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile each ``csrc/<name>.cu`` not built yet into
    ``_build/<name>-<hash>.so``, one ``nvcc`` per source, all started
    together; return every name's library path."""
    paths: Dict[str, str] = {}
    running = []
    for name in names:
        src, so = _so_path(name)
        paths[name] = so
        if os.path.exists(so):
            build_info.setdefault(name, {"path": so, "seconds": 0.0,
                                         "log": "cached"})
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.tmp%d" % (so, os.getpid())
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, src, so, tmp, proc, time.perf_counter()))
    failures = []
    for name, src, so, tmp, proc, t0 in running:
        try:
            log, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append("nvcc timed out on %s" % src)
            continue
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append("nvcc failed on %s (exit %d):\n%s"
                            % (src, proc.returncode, log))
            continue
        os.replace(tmp, so)
        build_info[name] = {"path": so, "seconds": secs,
                            "log": (log or "").strip()}
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def _load(name: str) -> ctypes.CDLL:
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_kernels((name,))[name])
            _bind(name, lib)
            _libs[name] = lib
        return lib


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "conv_epilogue": {"cxn_conv_epilogue": [_P, _P, _P, _P, _L, _I, _I, _I,
                                            _I, _P]},
    "bn_apply": {"cxn_bn_apply_fwd": [_P, _P, _P, _P, _L, _I, _I, _P],
                 "cxn_bn_apply_bwd": [_P, _P, _P, _P, _P, _P, _I, _P, _P,
                                      _L, _I, _L, _I, _P]},
    "matmul": {"cxn_matmul": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _P]},
    "relu_max_pool": {
        "cxn_relu_max_pool_fwd": [_P, _P, _I, _I, _I, _I, _I, _P],
        "cxn_relu_max_pool_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                                  _L, _L, _P]},
}


def _bind(name: str, lib: ctypes.CDLL) -> None:
    for fname, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _cuda_error(code: int) -> str:
    try:
        rt = ctypes.CDLL("libcudart.so")
        rt.cudaGetErrorString.restype = ctypes.c_char_p
        rt.cudaGetErrorString.argtypes = [ctypes.c_int]
        return rt.cudaGetErrorString(code).decode()
    except OSError:
        return "cudaError %d" % code


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError("%s kernel launch failed: %s"
                           % (what, _cuda_error(err)))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (what, t.device))


def _check_vec(what: str, nm: str, v: torch.Tensor, c: int,
               device: torch.device) -> None:
    if v.dtype != torch.float32 or tuple(v.shape) != (c,):
        raise ValueError("%s: %s must be float32 of shape (%d,), got %s %s"
                         % (what, nm, c, v.dtype, tuple(v.shape)))
    if v.device != device:
        raise ValueError("%s: %s is on %s, x on %s"
                         % (what, nm, v.device, device))
    if not v.is_contiguous():
        raise ValueError("%s: %s must be contiguous" % (what, nm))


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
        _check_vec("conv_epilogue", nm, v, c, x.device)
    if not x.is_contiguous():
        raise ValueError("conv_epilogue: x must be contiguous (the "
                         "kernel reads a dense NHWC buffer)")


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
    _require_cuda(x, "conv_epilogue")
    lib = _load("conv_epilogue")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = lib.cxn_conv_epilogue(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            x.numel(), x.shape[-1], _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out_dtype], int(bool(relu)), _stream(x))
    _raise_on(err, "conv_epilogue")
    conv_epilogue.launches += 1
    return y


conv_epilogue.launches = 0


# ------------------------------------------------------------ bn_apply


def bn_apply_plain(x: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """``relu?(x * scale + shift)`` per channel in x's dtype: the plain
    version of the bn_apply forward kernel (the reference's
    ``_bn_apply_kernel`` arithmetic)."""
    y = x * scale.to(x.dtype) + shift.to(x.dtype)
    return torch.relu(y) if relu else y


def bn_apply_bwd_plain(x: torch.Tensor, y: Optional[torch.Tensor],
                       dy: torch.Tensor, scale: torch.Tensor, relu: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """(dx, dscale, dshift) of ``y = relu?(x * scale + shift)``: the
    plain version of the bn_apply backward kernel, written as the
    reference's VJP (``pallas_kernels.py:305-322``) computes it."""
    dym = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    dx = bn_apply_plain(dym, scale, torch.zeros_like(scale), False)
    axes = tuple(range(x.dim() - 1))
    dscale = (dym * x).float().sum(axes)
    dshift = dym.float().sum(axes)
    return dx, dscale, dshift


def _check_bn(what: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype == torch.bfloat16:
        raise NotPortedError("%s on bfloat16 activations" % what,
                             Roadmap.LOW_PRECISION_TRAINING)
    if x.dtype != torch.float32:
        raise TypeError("%s: x must be float32, got %s" % (what, x.dtype))
    if x.dim() not in (2, 4) or x.shape[-1] < 1:
        raise ValueError("%s: x must be NHWC or (N, C), got shape %s"
                         % (what, tuple(x.shape)))
    _check_vec(what, "scale", scale, x.shape[-1], x.device)
    if not x.is_contiguous():
        raise ValueError("%s: x must be contiguous (the kernel reads a "
                         "dense NHWC buffer)" % what)


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """Row stride of ``t`` seen as a (rows, C) matrix with unit channel
    stride (a contiguous tensor, or a channel slice of a wider one), or
    None when no such view exists."""
    c = t.shape[-1]
    if t.stride(-1) != 1 and c != 1:
        return None
    ld = expect = None
    # size-1 axes carry any stride; every other row axis must nest
    for d in range(t.dim() - 2, -1, -1):
        if t.shape[d] == 1:
            continue
        if expect is None:
            ld = t.stride(d)
        elif t.stride(d) != expect:
            return None
        expect = t.stride(d) * t.shape[d]
    if ld is None:
        return c                         # a single row
    return int(ld) if ld >= c else None


def bn_apply_fwd(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 relu: bool) -> torch.Tensor:
    """``relu?(x * scale + shift)`` per channel (last axis of a
    contiguous float32 NHWC or (N, C) tensor): one launch of
    ``cxn_bn_apply_fwd`` (``csrc/bn_apply.cu``) for a CUDA tensor, the
    plain version for a CPU tensor."""
    _check_bn("bn_apply", x, scale)
    _check_vec("bn_apply", "shift", shift, x.shape[-1], x.device)
    if x.device.type == "cpu":
        return bn_apply_plain(x, scale, shift, relu)
    _require_cuda(x, "bn_apply")
    lib = _load("bn_apply")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = lib.cxn_bn_apply_fwd(x.data_ptr(), scale.data_ptr(),
                                   shift.data_ptr(), y.data_ptr(),
                                   x.numel(), x.shape[-1], int(bool(relu)),
                                   _stream(x))
    _raise_on(err, "bn_apply")
    bn_apply_fwd.launches += 1
    return y


bn_apply_fwd.launches = 0

_sm_counts: Dict[int, int] = {}


def _bwd_max_blocks(dev: torch.device) -> int:
    """Row blocks the backward kernel may use: 8 per SM, as its
    launcher caps them."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return 8 * _sm_counts[idx]


def bn_apply_bwd(x: torch.Tensor, y: Optional[torch.Tensor],
                 dy: torch.Tensor, scale: torch.Tensor, relu: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dshift) of ``y = relu?(x * scale + shift)`` from the
    forward's input ``x``, its output ``y`` (read only under ``relu``)
    and the cotangent ``dy``: one launch of ``cxn_bn_apply_bwd`` for
    CUDA tensors, the plain version for CPU tensors. ``dy`` may be a
    channel slice of a wider tensor."""
    _check_bn("bn_apply_bwd", x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("bn_apply_bwd: dy must match x, got %s %s on %s"
                         % (tuple(dy.shape), dy.dtype, dy.device))
    if relu and (y is None or y.shape != x.shape or y.dtype != x.dtype
                 or y.device != x.device or not y.is_contiguous()):
        raise ValueError("bn_apply_bwd: relu needs the forward output y, "
                         "contiguous and shaped like x")
    ld = _row_stride(dy)
    if ld is None:
        raise ValueError("bn_apply_bwd: dy must have unit channel stride "
                         "and rows at one stride, got strides %s"
                         % (dy.stride(),))
    if x.device.type == "cpu":
        return bn_apply_bwd_plain(x, y, dy, scale, relu)
    _require_cuda(x, "bn_apply_bwd")
    lib = _load("bn_apply")
    c = x.shape[-1]
    dx = torch.empty_like(x)
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dshift = torch.empty(c, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dscale.zero_(), dshift.zero_()
    max_blocks = _bwd_max_blocks(x.device)
    part = torch.empty(2 * max_blocks * c, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.cxn_bn_apply_bwd(
            x.data_ptr(), y.data_ptr() if relu else None, dy.data_ptr(),
            scale.data_ptr(), dx.data_ptr(), part.data_ptr(), max_blocks,
            dscale.data_ptr(), dshift.data_ptr(), x.numel() // c, c, ld,
            int(bool(relu)), _stream(x))
    _raise_on(err, "bn_apply_bwd")
    bn_apply_bwd.launches += 1
    return dx, dscale, dshift


bn_apply_bwd.launches = 0


class _BnApply(torch.autograd.Function):
    """Counterpart of the reference's ``bn_apply`` custom VJP: the
    forward and the backward are one kernel launch each."""

    @staticmethod
    def forward(ctx, x, scale, shift, relu):
        x = x.contiguous()
        y = bn_apply_fwd(x, scale.contiguous(), shift.contiguous(), relu)
        ctx.relu = relu
        ctx.save_for_backward(x, scale, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, y = ctx.saved_tensors
        if _row_stride(dy) is None:
            dy = dy.contiguous()
        dx, dscale, dshift = bn_apply_bwd(x, y, dy, scale.contiguous(),
                                          ctx.relu)
        return dx, dscale, dshift, None


def bn_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             relu: bool = False) -> torch.Tensor:
    """Fused BN epilogue ``relu?(x * scale + shift)``, differentiable in
    all three tensors (``scale``/``shift`` are the folded per-channel
    factors; the moments stay outside, so autograd composes through
    them)."""
    return _BnApply.apply(x, scale, shift, bool(relu))


# -------------------------------------------------------------- matmul


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 (the reference's ``jnp.dot`` with f32
    accumulation): the plain version of the matmul kernel."""
    return torch.matmul(a.float(), b.float())


def _mat_strides(t: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(row stride, column stride) of a 2-D operand the kernel reads in
    place (one of them 1), or None."""
    r, c = t.stride()
    if t.shape[1] == 1:
        c = 1
    elif t.shape[0] == 1:
        r = 1 if c != 1 else t.shape[1]
    if c == 1 or r == 1:
        return int(r), int(c)
    return None


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for float32 (M, K) and (K, N) operands, each read
    through its strides (row-major or transposed): one launch of
    ``csrc/matmul.cu`` for CUDA tensors, the plain version for CPU
    tensors. The output is a contiguous float32 (M, N)."""
    for nm, t in (("a", a), ("b", b)):
        if t.dtype == torch.bfloat16:
            raise NotPortedError("matmul on bfloat16 operands",
                                 Roadmap.LOW_PRECISION_TRAINING)
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError("matmul: %s must be a 2-D float32 tensor, got "
                             "%s %s" % (nm, t.dtype, tuple(t.shape)))
        if _mat_strides(t) is None:
            raise ValueError("matmul: %s must have a unit stride, got %s"
                             % (nm, t.stride()))
    if a.shape[1] != b.shape[0]:
        raise ValueError("matmul: inner dimensions differ: %s @ %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if a.device != b.device:
        raise ValueError("matmul: a on %s, b on %s" % (a.device, b.device))
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    _require_cuda(a, "matmul")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31 or (m + 63) // 64 > 65535:
        raise ValueError("matmul: shape %s @ %s exceeds the kernel's grid"
                         % (tuple(a.shape), tuple(b.shape)))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    (sam, sak), (sbk, sbn) = _mat_strides(a), _mat_strides(b)
    lib = _load("matmul")
    with torch.cuda.device(a.device):
        err = lib.cxn_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             m, n, k, sam, sak, sbk, sbn, _stream(a))
    _raise_on(err, "matmul")
    matmul_kernel.launches += 1
    return out


matmul_kernel.launches = 0


class _Matmul(torch.autograd.Function):
    """Counterpart of the reference's ``matmul`` custom VJP: the
    forward and both backward products (``dy·wᵀ``, ``xᵀ·dy``) run
    through the kernel, the transposes as strided views."""

    @staticmethod
    def forward(ctx, x, w):
        if _mat_strides(x) is None:
            x = x.contiguous()
        if _mat_strides(w) is None:
            w = w.contiguous()
        ctx.save_for_backward(x, w)
        return matmul_kernel(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if _mat_strides(dy) is None:
            dy = dy.contiguous()
        dx = matmul_kernel(dy, w.t()) if ctx.needs_input_grad[0] else None
        dw = matmul_kernel(x.t(), dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` through the matmul kernel, differentiable."""
    return _Matmul.apply(x, w)


# ------------------------------------------------------- relu_max_pool


def relu_max_pool_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """``maxpool_{k x k, stride 1, VALID}(max(x, 0))`` over NHWC: the
    plain version of the relu_max_pool forward kernel, in the reference
    kernel's order (the (0, 0) shift, then di outer, dj inner) with
    ``torch.maximum``'s NaN propagation."""
    r = torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
    oh, ow = x.shape[1] - k + 1, x.shape[2] - k + 1
    y = r[:, :oh, :ow]
    for di in range(k):
        for dj in range(k):
            if di or dj:
                y = torch.maximum(y, r[:, di:di + oh, dj:dj + ow])
    return y.contiguous()


def relu_max_pool_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                            dy: torch.Tensor, k: int) -> torch.Tensor:
    """dx of :func:`relu_max_pool_plain` from its input, output and
    cotangent, as the reference's backward kernel computes it: every
    input equal to its window's maximum gets the window's cotangent
    (every tied maximum, not the first only), summed in f32 over the
    windows in (di, dj) order, then the ``x > 0`` mask."""
    r = torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device)) \
        .float()
    yf, dyf = y.float(), dy.float()
    oh, ow = y.shape[1], y.shape[2]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for di in range(k):
        for dj in range(k):
            acc[:, di:di + oh, dj:dj + ow] += torch.where(
                r[:, di:di + oh, dj:dj + ow] == yf, dyf, zero)
    return torch.where(x > 0, acc, zero).to(x.dtype)


def _check_pool(what: str, x: torch.Tensor, k: int) -> None:
    if x.dtype == torch.bfloat16:
        raise NotPortedError("%s on bfloat16 activations" % what,
                             Roadmap.LOW_PRECISION_TRAINING)
    if x.dtype != torch.float32:
        raise TypeError("%s: x must be float32, got %s" % (what, x.dtype))
    if x.dim() != 4:
        raise ValueError("%s: x must be NHWC, got shape %s"
                         % (what, tuple(x.shape)))
    if k < 1 or k > x.shape[1] or k > x.shape[2]:
        raise ValueError("%s: window %d does not fit %s"
                         % (what, k, tuple(x.shape)))
    if max(x.shape) >= 2 ** 31:
        raise ValueError("%s: shape %s exceeds the kernel's int extents"
                         % (what, tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError("%s: x must be contiguous (the kernel reads a "
                         "dense NHWC buffer)" % what)


def relu_max_pool_fwd(x: torch.Tensor, k: int) -> torch.Tensor:
    """``maxpool_{k x k, stride 1, VALID}(max(x, 0))`` of a contiguous
    float32 NHWC tensor: one launch of ``cxn_relu_max_pool_fwd``
    (``csrc/relu_max_pool.cu``) for a CUDA tensor, the plain version for
    a CPU tensor."""
    _check_pool("relu_max_pool", x, k)
    if x.device.type == "cpu":
        return relu_max_pool_plain(x, k)
    _require_cuda(x, "relu_max_pool")
    b, h, w, c = x.shape
    y = torch.empty((b, h - k + 1, w - k + 1, c), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    lib = _load("relu_max_pool")
    with torch.cuda.device(x.device):
        err = lib.cxn_relu_max_pool_fwd(x.data_ptr(), y.data_ptr(), b, h, w,
                                        c, k, _stream(x))
    _raise_on(err, "relu_max_pool")
    relu_max_pool_fwd.launches += 1
    return y


relu_max_pool_fwd.launches = 0


def relu_max_pool_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                      k: int) -> torch.Tensor:
    """dx of :func:`relu_max_pool_fwd` from the forward's input ``x``,
    its output ``y`` (both contiguous) and the cotangent ``dy``, which
    the kernel reads through its strides (a permuted or expanded view
    costs no copy): one launch of ``cxn_relu_max_pool_bwd`` for CUDA
    tensors, the plain version for CPU tensors. Launches whose ``dy``
    is not a dense NHWC tensor are counted in ``strided_dy``."""
    _check_pool("relu_max_pool_bwd", x, k)
    b, h, w, c = x.shape
    oshape = (b, h - k + 1, w - k + 1, c)
    for nm, t in (("y", y), ("dy", dy)):
        if tuple(t.shape) != oshape or t.dtype != x.dtype \
                or t.device != x.device:
            raise ValueError("relu_max_pool_bwd: %s must be %s %s on %s, "
                             "got %s %s on %s"
                             % (nm, x.dtype, oshape, x.device, t.dtype,
                                tuple(t.shape), t.device))
    if not y.is_contiguous():
        raise ValueError("relu_max_pool_bwd: y must be contiguous")
    if x.device.type == "cpu":
        return relu_max_pool_bwd_plain(x, y, dy, k)
    _require_cuda(x, "relu_max_pool_bwd")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    lib = _load("relu_max_pool")
    sb, sh, sw, sc = dy.stride()
    with torch.cuda.device(x.device):
        err = lib.cxn_relu_max_pool_bwd(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), b, h,
            w, c, k, sb, sh, sw, sc, _stream(x))
    _raise_on(err, "relu_max_pool_bwd")
    relu_max_pool_bwd.launches += 1
    if not dy.is_contiguous():
        relu_max_pool_bwd.strided_dy += 1
    return dx


relu_max_pool_bwd.launches = 0
relu_max_pool_bwd.strided_dy = 0


class _ReluMaxPool(torch.autograd.Function):
    """Counterpart of the reference's ``relu_max_pool`` custom VJP: the
    forward and the backward are one kernel launch each; the residuals
    are the forward's input and output, as there."""

    @staticmethod
    def forward(ctx, x, k):
        x = x.contiguous()
        y = relu_max_pool_fwd(x, k)
        ctx.k = k
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return relu_max_pool_bwd(x, y, dy, ctx.k), None


def relu_max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Fused relu + k x k stride-1 VALID max pool (NHWC),
    differentiable; the backward credits every tied maximum."""
    return _ReluMaxPool.apply(x, int(k))


# ------------------------------------------------------------ counters

_COUNTED = {"conv_epilogue": conv_epilogue, "bn_apply_fwd": bn_apply_fwd,
            "bn_apply_bwd": bn_apply_bwd, "matmul": matmul_kernel,
            "relu_max_pool_fwd": relu_max_pool_fwd,
            "relu_max_pool_bwd": relu_max_pool_bwd}


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counter."""
    for fn in _COUNTED.values():
        fn.launches = 0
    relu_max_pool_bwd.strided_dy = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}
