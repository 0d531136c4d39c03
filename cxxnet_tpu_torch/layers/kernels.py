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

- ``conv_epilogue`` on float32, bfloat16 and int32 (an int8
  convolution's accumulator) input, differentiable for a float input:
  its backward is the ``bn_apply`` backward kernel on float32 x and y,
  ``conv_epilogue_bwd`` (``cxn_conv_epilogue_bwd``, in
  ``csrc/bn_apply.cu``) where either is bfloat16;
- ``bn_apply`` forward and backward (``bn_apply_fwd`` /
  ``bn_apply_bwd``) on float32 and bfloat16 activations,
  differentiable as :func:`bn_apply`; the backward launches as
  :func:`bn_bwd_plan` lays it out;
- ``matmul`` on float32 and bfloat16 operands (each its own dtype),
  differentiable as :func:`matmul`: the forward and both backward
  products run through the kernel, along the route and K splits
  :func:`matmul_plan` picks;
- ``relu_max_pool`` forward and backward (``relu_max_pool_fwd`` /
  ``relu_max_pool_bwd``) on float32 and bfloat16, differentiable as
  :func:`relu_max_pool`, launched along :func:`relu_max_pool_plan`;
- ``pool_concat`` forward and the pool branch's backward
  (``pool_concat_fwd`` / ``pool_concat_bwd``) on float32 and bfloat16,
  differentiable as :func:`pool_concat`, with the reference's fusion
  gate (:func:`pool_concat_applicable`);
- ``bias_grad_bf16``, the gradient of a bias added to a bf16 output,
  summed in bf16 in the reference's XLA:CPU order
  (:func:`xla_bias_sum_plan`), through :func:`bias_add`. It replaces no
  Pallas kernel: XLA's reduce.

The bf16 instantiations compute what the reference's dtype-generic
Pallas kernels compute under ``dtype = bfloat16``; their plain
versions, the oracle, round where PyTorch's bf16 tensor ops round.
``bn_apply``, ``matmul``, ``relu_max_pool`` and ``pool_concat`` count
their float32 and bfloat16 launches apart: ``launches`` and
``launches_bf16``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNEL_SOURCES = ("conv_epilogue", "bn_apply", "matmul", "relu_max_pool",
                  "pool_concat", "bias_grad_bf16")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# conv_epilogue's input may also be an int32 accumulator
_EPILOGUE_IN_CODE = {**_DTYPE_CODE, torch.int32: 2}

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
_F = ctypes.c_float
_SIGNATURES = {
    "conv_epilogue": {"cxn_conv_epilogue": [_P, _P, _P, _P, _L, _I, _I, _I,
                                            _I, _P]},
    "bn_apply": {"cxn_bn_apply_fwd": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
                 "cxn_bn_apply_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _L, _I, _L, _I, _I, _I, _I, _I, _I,
                                      _I, _P],
                 "cxn_conv_epilogue_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _L, _I, _L, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _P]},
    "matmul": {"cxn_matmul": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I,
                              _I, _I, _I, _L, _P]},
    "relu_max_pool": {
        "cxn_relu_max_pool_fwd": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _L, _P],
        "cxn_relu_max_pool_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                                  _L, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _L, _P]},
    "pool_concat": {
        "cxn_pool_concat_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I,
                                _I, _I, _P],
        "cxn_pool_concat_bwd": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                _F, _P, _I, _I, _I, _I, _P]},
    "bias_grad_bf16": {"cxn_bias_grad_bf16": [_P, _L, _L, _L, _L, _I, _I, _I,
                                              _I, _I, _P, _P, _L, _P, _P]},
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


def _count(fn, dtype: torch.dtype) -> None:
    """One launch of ``fn``'s kernel on ``dtype`` data: ``launches``
    counts the float32 ones, ``launches_bf16`` the bfloat16 ones."""
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


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
    plain PyTorch version of the conv_epilogue kernel. An int32 ``x``
    converts to float32 rounding to nearest even."""
    y = x.float() * scale + shift
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def _check_epilogue(x, scale, shift, out_dtype) -> None:
    if x.dtype not in _EPILOGUE_IN_CODE:
        raise TypeError("conv_epilogue: x must be float32, bfloat16 or an "
                        "int32 accumulator, got %s" % x.dtype)
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


def _epilogue_forward(x, scale, shift, relu, out_dtype) -> torch.Tensor:
    """The plain version for a CPU tensor, else one kernel launch."""
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
            x.numel(), x.shape[-1], _EPILOGUE_IN_CODE[x.dtype],
            _DTYPE_CODE[out_dtype], int(bool(relu)), _stream(x))
    _raise_on(err, "conv_epilogue")
    conv_epilogue.launches += 1
    if x.dtype == torch.int32:
        conv_epilogue.launches_int32 += 1
    elif x.dtype == torch.bfloat16:
        conv_epilogue.launches_bf16 += 1
    return y


def conv_epilogue_bwd_plain(x: torch.Tensor, y: Optional[torch.Tensor],
                            dy: torch.Tensor, scale: torch.Tensor,
                            relu: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(dx, dscale, dshift) of ``y = conv_epilogue(x, scale, shift,
    relu)`` as the reference's VJP computes it
    (``pallas_kernels.py:388-398``): ``dym = dy * [y > 0]`` in y's
    dtype; ``dx`` the f32 epilogue of dym with shift 0, ``f32(dym) *
    scale + 0`` rounded once to x's dtype (the ``+ 0`` turns -0 into
    +0); ``dscale = sum f32(dym) * f32(x)`` and ``dshift = sum
    f32(dym)`` in f32. The plain version of ``cxn_conv_epilogue_bwd``."""
    dym = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    dx = conv_epilogue_plain(dym, scale, torch.zeros_like(scale), False,
                             x.dtype)
    axes = tuple(range(x.dim() - 1))
    dymf = dym.float()
    return dx, (dymf * x.float()).sum(axes), dymf.sum(axes)


def _bwd_launch(entry, x: torch.Tensor, y: Optional[torch.Tensor],
                dy: torch.Tensor, scale: torch.Tensor, relu: bool, ld: int,
                codes: Tuple[int, ...], what: str
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the bn_apply backward kernel (``entry``: its
    bn_apply or conv_epilogue instantiation) on CUDA tensors, as
    :func:`bn_bwd_plan` lays it out: dx, dscale, dshift, the partial-sum
    scratch sized from the plan, and the device's arrival counters."""
    c = x.shape[-1]
    dx = torch.empty_like(x)
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dshift = torch.empty(c, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dscale.zero_(), dshift.zero_()
    ptrs = [x, dy, dx] + ([y] if relu else [])
    plan = bn_bwd_plan(x.numel() // c, c, ld, (x.dtype, dy.dtype),
                       aligned=all(t.data_ptr() % 16 == 0 for t in ptrs),
                       sms=_sm_count(x.device))
    part = torch.empty(max(plan["part_floats"], 4), dtype=torch.float32,
                       device=x.device)
    counters = _bwd_counters(x.device, plan["counters"])
    with torch.cuda.device(x.device):
        err = entry(
            x.data_ptr(), y.data_ptr() if relu else None, dy.data_ptr(),
            scale.data_ptr(), dx.data_ptr(), part.data_ptr(),
            counters.data_ptr(), dscale.data_ptr(), dshift.data_ptr(),
            x.numel() // c, c, ld, int(bool(relu)), *codes, plan["v"],
            plan["ct"], plan["rpi"], plan["nbx"], plan["group"],
            _stream(x))
    _raise_on(err, what)
    return dx, dscale, dshift


def conv_epilogue_bwd(x: torch.Tensor, y: Optional[torch.Tensor],
                      dy: torch.Tensor, scale: torch.Tensor, relu: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """conv_epilogue's VJP where x or y is bfloat16 ((x, y) of float32
    and bfloat16, not both float32): :func:`conv_epilogue_bwd_plain`'s
    function as one launch of ``cxn_conv_epilogue_bwd``
    (``csrc/bn_apply.cu``) for CUDA tensors, the plain version for CPU
    tensors. ``x`` is contiguous; ``y`` (read under ``relu``) contiguous
    and ``dy`` of y's dtype and shape, ``dy`` possibly a channel slice
    of a wider tensor. Counted in ``conv_epilogue.launches_bwd_bf16``."""
    for nm, t in (("x", x), ("dy", dy)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError("conv_epilogue_bwd: %s must be float32 or "
                            "bfloat16, got %s" % (nm, t.dtype))
    if x.dtype == dy.dtype == torch.float32:
        raise TypeError("conv_epilogue_bwd: float32 x and y take the "
                        "bn_apply backward (bn_apply_bwd)")
    if x.dim() not in (2, 4) or x.shape[-1] < 1 or not x.is_contiguous():
        raise ValueError("conv_epilogue_bwd: x must be a contiguous NHWC or "
                         "(N, C) tensor, got %s" % (tuple(x.shape),))
    _check_vec("conv_epilogue_bwd", "scale", scale, x.shape[-1], x.device)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError("conv_epilogue_bwd: dy must be shaped like x and on "
                         "its device")
    if relu and (y is None or y.shape != x.shape or y.dtype != dy.dtype
                 or y.device != x.device or not y.is_contiguous()):
        raise ValueError("conv_epilogue_bwd: relu needs the forward output "
                         "y, contiguous, of dy's dtype and x's shape")
    ld = _row_stride(dy)
    if ld is None:
        raise ValueError("conv_epilogue_bwd: dy must have unit channel stride "
                         "and rows at one stride, got strides %s"
                         % (dy.stride(),))
    if x.device.type == "cpu":
        return conv_epilogue_bwd_plain(x, y, dy, scale, relu)
    _require_cuda(x, "conv_epilogue_bwd")
    out = _bwd_launch(_load("bn_apply").cxn_conv_epilogue_bwd, x, y, dy,
                      scale, relu, ld,
                      (_DTYPE_CODE[x.dtype], _DTYPE_CODE[dy.dtype]),
                      "conv_epilogue_bwd")
    if x.numel():
        conv_epilogue.launches_bwd_bf16 += 1
    return out


class _ConvEpilogue(torch.autograd.Function):
    """Counterpart of the reference's ``conv_epilogue`` custom VJP
    (``pallas_kernels.py:388-398``: ``dym = dy * [y > 0]``, ``dx = dym *
    scale`` rounded once to x's dtype, f32 channel sums of ``dym * x``
    and ``dym``): the forward is one conv_epilogue launch, the backward
    one launch. On float32 x and y that arithmetic is the bn_apply
    backward kernel's, which it calls (``conv_epilogue.launches_bwd``
    counts these launches, each also one of ``bn_apply_bwd.launches``);
    where x or y is bfloat16 it is ``cxn_conv_epilogue_bwd``
    (``launches_bwd_bf16``)."""

    @staticmethod
    def forward(ctx, x, scale, shift, relu, out_dtype):
        y = _epilogue_forward(x, scale, shift, relu, out_dtype)
        ctx.relu = relu
        ctx.save_for_backward(x, scale, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, y = ctx.saved_tensors
        if _row_stride(dy) is None:
            dy = dy.contiguous()
        if x.dtype == dy.dtype == torch.float32:
            dx, dscale, dshift = bn_apply_bwd(x, y, dy, scale, ctx.relu)
            if x.device.type == "cuda":
                conv_epilogue.launches_bwd += 1
        else:
            dx, dscale, dshift = conv_epilogue_bwd(x, y, dy, scale, ctx.relu)
        return dx, dscale, dshift, None, None


def conv_epilogue(x: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, relu: bool,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``relu?(float(x) * scale + shift)`` per channel (last axis of a
    contiguous NHWC or (N, C) tensor), cast to ``out_dtype``: one
    launch of ``csrc/conv_epilogue.cu`` for a CUDA tensor, the plain
    version for a CPU tensor. ``x`` is float32, bfloat16 or the int32
    accumulator of an int8 convolution (then ``scale`` is its
    per-channel dequant). Differentiable in x, scale and shift for a
    float x; the int32 accumulator flows on the eval path only, so a
    differentiable call on it raises.

    ``launches`` counts every launch, ``launches_int32`` and
    ``launches_bf16`` those on an int32 and a bfloat16 input,
    ``launches_bwd`` and ``launches_bwd_bf16`` the backward's (see
    :class:`_ConvEpilogue`)."""
    _check_epilogue(x, scale, shift, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or shift.requires_grad):
        if x.dtype == torch.int32:
            raise TypeError("conv_epilogue: the int32 accumulator flows on "
                            "the eval path only; it has no gradient")
        return _ConvEpilogue.apply(x, scale, shift, bool(relu), out_dtype)
    return _epilogue_forward(x, scale, shift, relu, out_dtype)


conv_epilogue.launches = 0
conv_epilogue.launches_int32 = 0
conv_epilogue.launches_bf16 = 0
conv_epilogue.launches_bwd = 0
conv_epilogue.launches_bwd_bf16 = 0


# ------------------------------------------------------------ bn_apply


def bn_apply_plain(x: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """``relu?(x * scale + shift)`` per channel in x's dtype: the plain
    version of the bn_apply forward kernel (the reference's
    ``_bn_apply_kernel`` arithmetic). On bfloat16, scale and shift are
    rounded to bf16 and the product and the sum each round to bf16:
    ``bf16(bf16(x * bf16(s)) + bf16(t))``."""
    y = x * scale.to(x.dtype) + shift.to(x.dtype)
    return torch.relu(y) if relu else y


def bn_apply_bwd_plain(x: torch.Tensor, y: Optional[torch.Tensor],
                       dy: torch.Tensor, scale: torch.Tensor, relu: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """(dx, dscale, dshift) of ``y = relu?(x * scale + shift)``: the
    plain version of the bn_apply backward kernel, written as the
    reference's VJP (``pallas_kernels.py:305-322``) computes it. On
    bfloat16: ``dx = bf16(bf16(dym * bf16(s)) + 0)`` (the zero shift
    turns -0 into +0), ``dscale = sum f32(bf16(dym * x))`` and ``dshift
    = sum f32(dym)``, the sums in f32."""
    dym = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    dx = bn_apply_plain(dym, scale, torch.zeros_like(scale), False)
    axes = tuple(range(x.dim() - 1))
    dscale = (dym * x).float().sum(axes)
    dshift = dym.float().sum(axes)
    return dx, dscale, dshift


def _check_bn(what: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("%s: x must be float32 or bfloat16, got %s"
                        % (what, x.dtype))
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
    contiguous float32 or bfloat16 NHWC or (N, C) tensor; float32 scale
    and shift) in x's dtype: one launch of ``cxn_bn_apply_fwd``
    (``csrc/bn_apply.cu``) for a CUDA tensor, the plain version for a
    CPU tensor."""
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
                                   _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(err, "bn_apply")
    _count(bn_apply_fwd, x.dtype)
    return y


bn_apply_fwd.launches = 0
bn_apply_fwd.launches_bf16 = 0

_sm_counts: Dict[int, int] = {}
# per device: the bn_apply backward's arrival counters, zero between
# launches (each launch's finishing blocks reset theirs)
_counter_bufs: Dict[int, torch.Tensor] = {}


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


def _sm_count(dev: torch.device) -> int:
    idx = _dev_index(dev)
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _bwd_counters(dev: torch.device, n: int) -> torch.Tensor:
    """The device's persistent, zeroed arrival counters, at least ``n``
    (allocated once, grown on demand)."""
    idx = _dev_index(dev)
    buf = _counter_bufs.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _counter_bufs[idx] = buf
    return buf


BN_BWD_MAX_THREADS = 256       # csrc/bn_apply.cu's kBwdMaxThreads
BN_BWD_ROWS = 4                # rows a thread loads before their first use
# resident threads an SM the row blocks aim at, per byte an element
# moves in x, y, dy and dx together (bf16: 8 bytes, 256 threads;
# float32: 512): fewer, longer blocks measured faster than a full card
# of short ones
BN_BWD_SM_THREADS = 32
BN_BWD_PART_SHARE = 0.05       # partial-sum bytes against the layer's


def bn_bwd_plan(rows: int, c: int, ld_dy: int, dtypes, aligned: bool = True,
                sms: int = 132) -> Dict[str, int]:
    """The launch of the bn_apply backward kernel (``cxn_bn_bwd``) for a
    (rows, c) layer whose x and y have ``dtypes`` (torch dtypes or their
    names), dy at row stride ``ld_dy``, on a card with ``sms`` SMs.

    - ``v``: channels a vector, 16 bytes of bf16 (8) or float32 (4)
      where c, ld_dy and the bases allow it (x and y of two dtypes: 4,
      measured faster than 8 there), else 4 or 1;
    - ``ct`` channel vectors (all ``nv`` of them up to
      ``BN_BWD_MAX_THREADS``, else ``tiles`` equal tiles) times ``rpi``
      row groups make the block, one thread for each pair; ``rpi``
      fills the block in whole warps where that fits;
    - ``nbx`` row blocks: enough for ``BN_BWD_SM_THREADS`` threads an
      SM for every byte an element moves (bf16 256, float32 512), at
      most as many as keep the partial rows' traffic (written
      and read back, ``16 c`` bytes a row, group rows included) within
      5 % of the layer's (x, y, dy read, dx written), and no more than
      give each thread one iteration of ``BN_BWD_ROWS`` rows, unless
      that leaves SMs without a block;
    - ``group`` consecutive row blocks are added by their last block,
      then the ``ngroups`` group rows by the last group;
    - ``part_floats`` and ``counters``: the scratch and arrival
      counters the launch needs."""
    names = [d if isinstance(d, str) else str(d).replace("torch.", "")
             for d in dtypes]
    sizes = [2 if n == "bfloat16" else 4 for n in names]
    v = 8 if sizes == [2, 2] else 4
    while v > 1 and (c % v or ld_dy % v or not aligned):
        v //= 2 if v == 8 else 4
    nv = c // v
    tiles = -(-nv // BN_BWD_MAX_THREADS)
    ct = -(-nv // tiles)
    g = 32 // math.gcd(ct, 32)
    rpi = max(1, BN_BWD_MAX_THREADS // ct)
    if ct * g <= BN_BWD_MAX_THREADS:
        rpi = max(g, rpi // g * g)
    threads = ct * rpi
    layer_bytes = rows * c * 2 * sum(sizes)
    want = -(-sms * BN_BWD_SM_THREADS * 2 * sum(sizes) // (threads * tiles))
    most = max(min(sms, rows), -(-rows // (rpi * BN_BWD_ROWS)))
    nbx = max(1, min(want, most))

    def shape(n):
        per = -(-rows // n)
        n = -(-rows // per)
        grp = math.isqrt(n - 1) + 1 if n > 1 else 1
        return n, grp, -(-n // grp)

    nbx, group, ngroups = shape(nbx)
    while nbx > 1 and 16 * c * (nbx + ngroups) > \
            BN_BWD_PART_SHARE * layer_bytes:
        nbx, group, ngroups = shape(nbx - 1)
    part_floats = 2 * c * (nbx + ngroups) if nbx > 1 else 0
    return {"v": v, "nv": nv, "ct": ct, "tiles": tiles, "rpi": rpi,
            "threads": threads, "nbx": nbx,
            "group": group, "ngroups": ngroups, "blocks": nbx * tiles,
            "part_floats": part_floats,
            "counters": tiles * (ngroups + 1),
            "layer_bytes": layer_bytes, "part_bytes": 8 * part_floats}


def bn_apply_bwd(x: torch.Tensor, y: Optional[torch.Tensor],
                 dy: torch.Tensor, scale: torch.Tensor, relu: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dshift) of ``y = relu?(x * scale + shift)`` from the
    forward's input ``x``, its output ``y`` (read only under ``relu``)
    and the cotangent ``dy``, all of x's dtype (float32 or bfloat16):
    one launch of ``cxn_bn_apply_bwd`` for CUDA tensors, the plain
    version for CPU tensors. ``dy`` may be a channel slice of a wider
    tensor; dscale and dshift are float32."""
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
    out = _bwd_launch(_load("bn_apply").cxn_bn_apply_bwd, x, y, dy, scale,
                      relu, ld, (_DTYPE_CODE[x.dtype],), "bn_apply_bwd")
    if x.numel():
        _count(bn_apply_bwd, x.dtype)
    return out


bn_apply_bwd.launches = 0
bn_apply_bwd.launches_bf16 = 0


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
    accumulation and output, on float32 or bfloat16 operands): the
    plain version of the matmul kernel. A bf16 operand converts to
    float32 exactly."""
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


MATMUL_ROUTES = {"fma": 0, "wgmma": 1}
# output tile (M, N) and K slice of each route's block
MATMUL_TILES = {"fma": (64, 64, 32), "wgmma": (64, 64, 64)}
# CTAs of a cluster: up to 8 is portable, but an 8-CTA cluster took ~5 us
# longer to schedule than a 4-CTA one at fc1's shapes on the H100
MATMUL_MAX_SPLITS = 4
MATMUL_MIN_BLOCKS = 120          # blocks a product should fill


def matmul_plan(m: int, k: int, n: int, strides, dtypes,
                aligned: bool = True) -> Dict[str, object]:
    """The launch of ``csrc/matmul.cu`` for an (m, k) . (k, n) product
    whose operands have ``strides`` ((sam, sak), (sbk, sbn)) and
    ``dtypes`` (torch dtypes or their names); ``aligned``: both bases
    16-byte aligned.

    - ``route``: ``"wgmma"`` (the bf16 tensor cores, operands by TMA)
      for bf16 . bf16 with A k-contiguous and B n-contiguous whose row
      strides are whole 16-byte units on aligned bases, as TMA needs;
      ``"fma"`` (float32 FMA units) for every other product;
    - ``splits``: the CTAs of a cluster that split K, the fewest (up to
      ``MATMUL_MAX_SPLITS``) that bring the blocks to
      ``MATMUL_MIN_BLOCKS``, while every split keeps at least two K
      slices (fc1's forward and ``dy·wᵀ``: 32 tiles in 4 splits);
    - ``blocks``: output tiles times splits, the launch's grid."""
    (sam, sak), (sbk, sbn) = strides
    names = [d if isinstance(d, str) else str(d).replace("torch.", "")
             for d in dtypes]
    tc = (names == ["bfloat16", "bfloat16"] and sak == 1 and sbn == 1
          and aligned and (2 * sam) % 16 == 0 and (2 * sbk) % 16 == 0)
    route = "wgmma" if tc else "fma"
    bm, bn, bk = MATMUL_TILES[route]
    tiles = -(-m // bm) * -(-n // bn)
    slices = -(-k // bk)
    splits = 1
    while (tiles * splits < MATMUL_MIN_BLOCKS
           and splits < MATMUL_MAX_SPLITS and slices >= 2 * (splits + 1)):
        splits += 1
    return {"route": route, "splits": splits, "blocks": tiles * splits,
            "tiles": tiles, "tile": (bm, bn, bk)}


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for (M, K) and (K, N) operands, each float32 or
    bfloat16 and read through its strides (row-major or transposed):
    one launch of ``csrc/matmul.cu`` for CUDA tensors, along the route
    :func:`matmul_plan` picks, the plain version for CPU tensors. The
    output is a contiguous float32 (M, N). A launch with a bfloat16
    operand counts in ``launches_bf16``, one on two float32 operands in
    ``launches``; ``last_plan`` keeps the last launch's plan."""
    for nm, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPE_CODE or t.dim() != 2:
            raise ValueError("matmul: %s must be a 2-D float32 or bfloat16 "
                             "tensor, got %s %s"
                             % (nm, t.dtype, tuple(t.shape)))
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
    strides = (_mat_strides(a), _mat_strides(b))
    plan = matmul_plan(m, k, n, strides, (a.dtype, b.dtype),
                       aligned=a.data_ptr() % 16 == 0
                       and b.data_ptr() % 16 == 0)
    (sam, sak), (sbk, sbn) = strides
    lib = _load("matmul")
    with torch.cuda.device(a.device):
        err = lib.cxn_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             m, n, k, sam, sak, sbk, sbn,
                             _DTYPE_CODE[a.dtype], _DTYPE_CODE[b.dtype],
                             MATMUL_ROUTES[plan["route"]], plan["splits"],
                             plan["blocks"], _stream(a))
    _raise_on(err, "matmul")
    matmul_kernel.last_plan = plan
    _count(matmul_kernel, torch.bfloat16
           if torch.bfloat16 in (a.dtype, b.dtype) else torch.float32)
    return out


matmul_kernel.launches = 0
matmul_kernel.last_plan = None
matmul_kernel.launches_bf16 = 0


class _Matmul(torch.autograd.Function):
    """Counterpart of the reference's ``matmul`` custom VJP: the
    forward and both backward products (``dy·wᵀ``, ``xᵀ·dy``) run
    through the kernel, the transposes as strided views. The output and
    so ``dy`` are float32; dx and dw are cast to their operand's dtype,
    as the reference casts them (``pallas_kernels.py:79-83``): under
    bf16 operands the two backward products are f32·bf16 and
    bf16·f32."""

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
        dx = matmul_kernel(dy, w.t()).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = matmul_kernel(x.t(), dy).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
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
    windows in (di, dj) order, then the ``x > 0`` mask, rounded once to
    x's dtype (bfloat16 compares exactly in f32)."""
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
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("%s: x must be float32 or bfloat16, got %s"
                        % (what, x.dtype))
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


RMP_ROUTES = {"generic": 0, "slide": 1}
RMP_SLIDE_K = (2, 3)             # windows the slide route is built for
RMP_THREADS = 256                # the generic route's block
# threads a slide block (at most): the backward's ~117 registers a
# thread allow ~512 threads an SM, which smaller blocks pack better
RMP_SLIDE_THREADS = {"fwd": 256, "bwd": 128}
# rows a slide strip walks (at most; halved to RMP_MIN_ROWS while an SM
# would get fewer than RMP_SM_BLOCKS blocks)
RMP_ROWS = {"fwd": 4, "bwd": 8}
RMP_MIN_ROWS = 4
RMP_SM_BLOCKS = 8
# channels a slide vector: 16 bytes
RMP_VECS = {"float32": 4, "bfloat16": 8}
RMP_GENERIC_BLOCKS_PER_SM = 16   # the generic grid-stride loop's cap


def _alignment(*ts: torch.Tensor) -> int:
    """The largest of 16, 8, 4, 2, 1 bytes that divides every base."""
    a = 16
    for t in ts:
        while t.data_ptr() % a:
            a //= 2
    return a


def relu_max_pool_plan(b: int, h: int, w: int, c: int, k: int, dtype,
                       align: int = 16, dy_strides=None,
                       sms: int = 132) -> Dict[str, object]:
    """The launch of a relu_max_pool kernel on a (b, h, w, c) input of
    ``dtype`` (a torch dtype or its name) with window ``k``, whose
    tensors' bases share ``align`` bytes of alignment, on a card with
    ``sms`` SMs: the forward's where ``dy_strides`` is None, else the
    backward's with the cotangent read through ``dy_strides``.

    - ``route`` ``"slide"`` (k in ``RMP_SLIDE_K``; C a multiple of the
      16-byte vector ``v``, 16-byte aligned bases; dy with unit channel
      stride and strides that keep its vectors aligned; h*w*c below
      2^31): a block of ``ct`` channel vectors by ``tw`` columns (at
      most ``RMP_SLIDE_THREADS``) walks a strip of ``rows`` rows
      (output rows forward, input rows backward) down its columns;
      ``tiles`` column tiles, ``ctiles`` channel tiles and ``strips``
      strips a map, ``blocks`` in all. ``rows`` halves from ``RMP_ROWS`` (down
      to ``RMP_MIN_ROWS``) while the launch would give an SM fewer
      than ``RMP_SM_BLOCKS`` blocks;
    - else ``"generic"``: one thread per ``v`` = 4 channels (C a
      multiple of 4, 4-element alignment, unit-stride dy) or per
      channel, in a grid-stride loop of ``blocks`` blocks of
      ``RMP_THREADS``, at most ``RMP_GENERIC_BLOCKS_PER_SM`` an SM.
    The plan is chosen by shape, on the host, and is not a fallback:
    the kernel refuses a plan its tensors cannot take."""
    name = dtype if isinstance(dtype, str) else \
        str(dtype).replace("torch.", "")
    esz = 2 if name == "bfloat16" else 4
    oh, ow = h - k + 1, w - k + 1
    bwd = dy_strides is not None
    span, height = (w, h) if bwd else (ow, oh)

    def vec_ok(v: int) -> bool:
        if c % v or align % (v * esz):
            return False
        if bwd and v > 1:
            sb, sh, sw, sc = (int(s) for s in dy_strides)
            return sc == 1 and sb % v == 0 and sh % v == 0 and sw % v == 0
        return True

    v = RMP_VECS[name]
    if k in RMP_SLIDE_K and vec_ok(v) and h * w * c < 2 ** 31:
        way = "bwd" if bwd else "fwd"
        most = RMP_SLIDE_THREADS[way]
        cv = c // v
        ctiles = -(-cv // most)
        ct = -(-cv // ctiles)
        tw = max(1, min(span, most // ct))
        tiles = -(-span // tw)

        def blocks_for(r):
            return b * ctiles * tiles * -(-height // r)

        rows = min(RMP_ROWS[way], height)
        while rows > RMP_MIN_ROWS and \
                blocks_for(rows) < RMP_SM_BLOCKS * sms:
            rows = max(RMP_MIN_ROWS, rows // 2)
        return {"route": "slide", "v": v, "rows": rows, "tw": tw, "ct": ct,
                "tiles": tiles, "ctiles": ctiles,
                "strips": -(-height // rows), "blocks": blocks_for(rows),
                "threads": tw * ct}
    v = 4 if vec_ok(4) else 1
    work = b * (h if bwd else oh) * (w if bwd else ow) * (c // v)
    blocks = max(1, min(-(-work // RMP_THREADS),
                        RMP_GENERIC_BLOCKS_PER_SM * sms))
    return {"route": "generic", "v": v, "rows": 0, "tw": 0, "ct": 0,
            "tiles": 0, "ctiles": 0, "strips": 0, "blocks": blocks,
            "threads": RMP_THREADS}


def _plan_args(plan) -> Tuple:
    return (RMP_ROUTES[plan["route"]], plan["v"], plan["rows"], plan["tw"],
            plan["ct"], plan["tiles"], plan["ctiles"], plan["strips"],
            plan["blocks"])


def relu_max_pool_fwd(x: torch.Tensor, k: int) -> torch.Tensor:
    """``maxpool_{k x k, stride 1, VALID}(max(x, 0))`` of a contiguous
    float32 or bfloat16 NHWC tensor: one launch of
    ``cxn_relu_max_pool_fwd`` (``csrc/relu_max_pool.cu``) along
    :func:`relu_max_pool_plan` for a CUDA tensor (the plan in
    ``relu_max_pool_fwd.last_plan``), the plain version for a CPU
    tensor."""
    _check_pool("relu_max_pool", x, k)
    if x.device.type == "cpu":
        return relu_max_pool_plain(x, k)
    _require_cuda(x, "relu_max_pool")
    b, h, w, c = x.shape
    y = torch.empty((b, h - k + 1, w - k + 1, c), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    plan = relu_max_pool_plan(b, h, w, c, k, x.dtype, _alignment(x, y),
                              sms=_sm_count(x.device))
    lib = _load("relu_max_pool")
    with torch.cuda.device(x.device):
        err = lib.cxn_relu_max_pool_fwd(x.data_ptr(), y.data_ptr(), b, h, w,
                                        c, k, _DTYPE_CODE[x.dtype],
                                        *_plan_args(plan), _stream(x))
    _raise_on(err, "relu_max_pool")
    relu_max_pool_fwd.last_plan = plan
    _count(relu_max_pool_fwd, x.dtype)
    return y


relu_max_pool_fwd.launches = 0
relu_max_pool_fwd.launches_bf16 = 0
relu_max_pool_fwd.last_plan = None


def relu_max_pool_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                      k: int) -> torch.Tensor:
    """dx of :func:`relu_max_pool_fwd` from the forward's input ``x``,
    its output ``y`` (both contiguous) and the cotangent ``dy``, which
    the kernel reads through its strides (a permuted or expanded view
    costs no copy): one launch of ``cxn_relu_max_pool_bwd`` along
    :func:`relu_max_pool_plan` for CUDA tensors (the plan in
    ``relu_max_pool_bwd.last_plan``), the plain version for CPU
    tensors. Launches whose ``dy`` is not a dense NHWC tensor are
    counted in ``strided_dy``."""
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
    strides = dy.stride()
    plan = relu_max_pool_plan(b, h, w, c, k, x.dtype,
                              _alignment(x, y, dy, dx), strides,
                              sms=_sm_count(x.device))
    lib = _load("relu_max_pool")
    with torch.cuda.device(x.device):
        err = lib.cxn_relu_max_pool_bwd(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), b, h,
            w, c, k, *strides, _DTYPE_CODE[x.dtype], *_plan_args(plan),
            _stream(x))
    _raise_on(err, "relu_max_pool_bwd")
    relu_max_pool_bwd.last_plan = plan
    _count(relu_max_pool_bwd, x.dtype)
    if not dy.is_contiguous():
        relu_max_pool_bwd.strided_dy += 1
    return dx


relu_max_pool_bwd.launches = 0
relu_max_pool_bwd.launches_bf16 = 0
relu_max_pool_bwd.strided_dy = 0
relu_max_pool_bwd.last_plan = None


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


# --------------------------------------------------------- pool_concat

POOL_CONCAT_MAX_BRANCHES = 8
_POOL_MODES = {"max": 0, "avg": 1}


def _inv_window(k: int, dtype: torch.dtype) -> float:
    """1 / (k * k) rounded to ``dtype``, as a Python float (exact): the
    constant the reference multiplies an avg window's sum by in the
    forward (the output dtype) and each window's cotangent by in the
    backward (float32)."""
    return float(torch.tensor(1.0 / (k * k), dtype=dtype))


def pool_concat_plain(branches: Sequence[torch.Tensor], pos: int, k: int,
                      mode: str) -> torch.Tensor:
    """The channel concat of NHWC ``branches``, each cast to the first's
    dtype, with branch ``pos`` reduced on the way by a k x k stride-1
    max or avg window over its zero-padded (pad k // 2) map: the plain
    version of the pool_concat forward kernel, in the reference
    kernel's order (``pallas_kernels.py:412-435``: the (0, 0) shift,
    then di outer, dj inner; ``torch.maximum``'s NaN propagation; avg
    adds rounded in the dtype, then one product with 1/(k*k) rounded to
    the dtype)."""
    dtype = branches[0].dtype
    xs = [x.to(dtype) for x in branches]
    p = k // 2
    h, w = xs[pos].shape[1], xs[pos].shape[2]
    xp = F.pad(xs[pos], (0, 0, p, p, p, p))
    y = xp[:, :h, :w]
    for di in range(k):
        for dj in range(k):
            if di or dj:
                sl = xp[:, di:di + h, dj:dj + w]
                y = torch.maximum(y, sl) if mode == "max" else y + sl
    if mode == "avg":
        y = y * _inv_window(k, dtype)
    xs[pos] = y
    return torch.cat(xs, dim=3)


def pool_concat_bwd_plain(x: torch.Tensor, out: Optional[torch.Tensor],
                          dy: torch.Tensor, off: int, k: int,
                          mode: str) -> torch.Tensor:
    """The gradient of the pool branch ``x`` of :func:`pool_concat_plain`
    (its segment starts at channel ``off`` of the output ``out`` and of
    the cotangent ``dy``), written as the reference's VJP computes it
    (``pallas_kernels.py:494-524``): an f32 scatter over the padded map
    in (di, dj) order of, per window, the cotangent where the input
    equals the window's output (max: every tied maximum; ``out`` is read
    for that only) or the cotangent times f32 1/(k*k) (avg); cropped
    and rounded once to x's dtype. (On float64 tensors, a precision
    witness's plain path, it computes in float64.)"""
    b, h, w, c = x.shape
    p = k // 2
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    dyf = dy[..., off:off + c].to(acc_t)
    acc = torch.zeros((b, h + 2 * p, w + 2 * p, c), dtype=acc_t,
                      device=x.device)
    zero = torch.zeros((), dtype=acc_t, device=x.device)
    if mode == "max":
        xp = F.pad(x.to(acc_t), (0, 0, p, p, p, p))
        yf = out[..., off:off + c].to(acc_t)
    for di in range(k):
        for dj in range(k):
            if mode == "max":
                contrib = torch.where(xp[:, di:di + h, dj:dj + w] == yf, dyf,
                                      zero)
            else:
                contrib = dyf * _inv_window(k, acc_t)
            acc[:, di:di + h, dj:dj + w] += contrib
    return acc[:, p:p + h, p:p + w].to(x.dtype)


def _check_pool_concat(branches: Sequence[torch.Tensor], pos: int, k: int,
                       mode: str) -> None:
    n = len(branches)
    if not 2 <= n <= POOL_CONCAT_MAX_BRANCHES:
        raise ValueError("pool_concat: 2 to %d branches, got %d"
                         % (POOL_CONCAT_MAX_BRANCHES, n))
    if not 0 <= pos < n:
        raise ValueError("pool_concat: pool branch %d of %d" % (pos, n))
    if mode not in _POOL_MODES:
        raise ValueError("pool_concat: mode must be max or avg, got %r"
                         % (mode,))
    if k < 1 or k % 2 == 0:
        raise ValueError("pool_concat: the window must be odd, got %d" % k)
    lead = tuple(branches[0].shape[:3])
    for x in branches:
        if x.dtype not in _DTYPE_CODE or x.dim() != 4:
            raise ValueError("pool_concat: branches must be float32 or "
                             "bfloat16 NHWC tensors, got %s %s"
                             % (x.dtype, tuple(x.shape)))
        if tuple(x.shape[:3]) != lead or x.device != branches[0].device:
            raise ValueError("pool_concat: every branch must be (B, H, W) = "
                             "%s on %s, got %s on %s"
                             % (lead, branches[0].device, tuple(x.shape),
                                x.device))
    if max(max(x.shape) for x in branches) >= 2 ** 31 \
            or sum(x.shape[3] for x in branches) >= 2 ** 31:
        raise ValueError("pool_concat: shapes exceed the kernel's int extents")


def pool_concat_fwd(branches: Sequence[torch.Tensor], pos: int, k: int,
                    mode: str) -> torch.Tensor:
    """:func:`pool_concat_plain`'s function as one launch of
    ``cxn_pool_concat_fwd`` (``csrc/pool_concat.cu``) for CUDA tensors,
    each branch read through its strides (a dense NHWC tensor or a
    channels-last view: no copy), the plain version for CPU tensors.
    The output is a dense NHWC tensor of the first branch's dtype."""
    _check_pool_concat(branches, pos, k, mode)
    x0 = branches[0]
    if x0.device.type == "cpu":
        return pool_concat_plain(branches, pos, k, mode)
    _require_cuda(x0, "pool_concat")
    b, h, w = x0.shape[:3]
    n = len(branches)
    out = torch.empty((b, h, w, sum(x.shape[3] for x in branches)),
                      dtype=x0.dtype, device=x0.device)
    if out.numel() == 0:
        return out
    ptrs = (ctypes.c_void_p * n)(*[x.data_ptr() for x in branches])
    strides = (ctypes.c_longlong * (4 * n))(
        *[s for x in branches for s in x.stride()])
    chans = (ctypes.c_int * n)(*[x.shape[3] for x in branches])
    dtypes = (ctypes.c_int * n)(*[_DTYPE_CODE[x.dtype] for x in branches])
    lib = _load("pool_concat")
    with torch.cuda.device(x0.device):
        err = lib.cxn_pool_concat_fwd(
            n, ctypes.addressof(ptrs), ctypes.addressof(strides),
            ctypes.addressof(chans), ctypes.addressof(dtypes), pos, k,
            _POOL_MODES[mode], _inv_window(k, x0.dtype), out.data_ptr(),
            _DTYPE_CODE[x0.dtype], b, h, w, _stream(x0))
    _raise_on(err, "pool_concat")
    _count(pool_concat_fwd, x0.dtype)
    return out


pool_concat_fwd.launches = 0
pool_concat_fwd.launches_bf16 = 0


def pool_concat_bwd(x: torch.Tensor, out: Optional[torch.Tensor],
                    dy: torch.Tensor, off: int, k: int,
                    mode: str) -> torch.Tensor:
    """The pool branch's gradient (:func:`pool_concat_bwd_plain`) from
    the branch ``x``, the forward's output ``out`` (read under max only)
    and the cotangent ``dy`` of the output, all read through their
    strides (a permuted ``dy`` costs no copy): one launch of
    ``cxn_pool_concat_bwd`` for CUDA tensors, the plain version for CPU
    tensors. dx is a dense NHWC tensor of x's dtype. Counted by dy's
    dtype (the concat's)."""
    if x.dtype not in _DTYPE_CODE or dy.dtype not in _DTYPE_CODE \
            or x.dim() != 4 or dy.dim() != 4:
        raise ValueError("pool_concat_bwd: x and dy must be float32 or "
                         "bfloat16 NHWC tensors")
    b, h, w, c = x.shape
    if tuple(dy.shape[:3]) != (b, h, w) or not 0 <= off <= dy.shape[3] - c \
            or dy.device != x.device:
        raise ValueError("pool_concat_bwd: dy %s does not hold x %s at "
                         "channel %d" % (tuple(dy.shape), tuple(x.shape),
                                         off))
    if mode not in _POOL_MODES or k < 1 or k % 2 == 0:
        raise ValueError("pool_concat_bwd: mode %r, window %d" % (mode, k))
    if mode == "max" and (out is None or out.shape != dy.shape
                          or out.dtype != dy.dtype
                          or out.device != x.device):
        raise ValueError("pool_concat_bwd: max needs the forward's output, "
                         "shaped and typed like dy")
    if x.device.type == "cpu":
        return pool_concat_bwd_plain(x, out, dy, off, k, mode)
    _require_cuda(x, "pool_concat_bwd")
    dx = torch.empty((b, h, w, c), dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx
    xs = (ctypes.c_longlong * 4)(*x.stride())
    ds = (ctypes.c_longlong * 4)(*dy.stride())
    # the output is read under max only
    os_ = (ctypes.c_longlong * 4)(*(out.stride() if out is not None
                                    else (0, 0, 0, 0)))
    lib = _load("pool_concat")
    with torch.cuda.device(x.device):
        err = lib.cxn_pool_concat_bwd(
            x.data_ptr(), _DTYPE_CODE[x.dtype], ctypes.addressof(xs),
            dy.data_ptr(), out.data_ptr() if out is not None else None,
            _DTYPE_CODE[dy.dtype], ctypes.addressof(ds), ctypes.addressof(os_),
            off, k, _POOL_MODES[mode], _inv_window(k, torch.float32),
            dx.data_ptr(), b, h, w, c, _stream(x))
    _raise_on(err, "pool_concat_bwd")
    _count(pool_concat_bwd, dy.dtype)
    return dx


pool_concat_bwd.launches = 0
pool_concat_bwd.launches_bf16 = 0


class _PoolConcat(torch.autograd.Function):
    """Counterpart of the reference's ``pool_concat`` custom VJP
    (``pallas_kernels.py:466-527``): the forward is one pool_concat
    launch; the backward one launch for the pool branch, and for each
    plain branch its channel slice of dy (a view when the branch's dtype
    is the concat's, else a cast). The residuals are the pool branch and
    (max) the forward's output, whose segment is the reference's
    ``y_pool``."""

    @staticmethod
    def forward(ctx, pos, k, mode, *branches):
        out = pool_concat_fwd(branches, pos, k, mode)
        ctx.pos, ctx.k, ctx.mode = pos, k, mode
        ctx.widths = [x.shape[3] for x in branches]
        ctx.dtypes = [x.dtype for x in branches]
        ctx.save_for_backward(branches[pos],
                              out if mode == "max" else None)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, out = ctx.saved_tensors
        grads, off = [], 0
        for i, (c, dt) in enumerate(zip(ctx.widths, ctx.dtypes)):
            if not ctx.needs_input_grad[3 + i]:
                grads.append(None)
            elif i == ctx.pos:
                grads.append(pool_concat_bwd(x, out, dy, off, ctx.k,
                                             ctx.mode))
            else:
                seg = dy[..., off:off + c]
                grads.append(seg if seg.dtype == dt else seg.to(dt))
            off += c
        return (None, None, None, *grads)


def pool_concat_applicable(h: int, w: int, total_ch: int, k: int,
                           itemsize: int) -> bool:
    """The reference's fusion gate (``pallas_kernels.py:530-540``), kept
    as it is so that both packages fuse the same concats: an odd window
    larger than 1, and three copies of the padded (H, W, Ctotal) item
    (Ctotal rounded up to 128 lanes) within 6 MiB of TPU VMEM."""
    if k <= 1 or k % 2 == 0:
        return False
    lanes = -(-total_ch // 128) * 128
    per_item = (h + 2 * (k // 2)) * (w + 2 * (k // 2)) * lanes * itemsize
    return 3 * per_item <= 6 * 1024 * 1024


def pool_concat(branches: Sequence[torch.Tensor], pos: int, k: int,
                mode: str) -> torch.Tensor:
    """Fused Inception tower tail: ``ch_concat(branches)`` where branch
    ``pos`` is the UN-pooled input of a k x k stride-1 SAME (zero pad
    k // 2) max or avg pool, reduced on the way into its channel
    segment; differentiable (every tied maximum credited, avg spread
    uniformly). One kernel launch forward and one backward on CUDA
    tensors (``pool_concat_fwd`` / ``pool_concat_bwd`` count float32
    and bfloat16 launches apart, by the concat's dtype)."""
    branches = tuple(branches)
    if torch.is_grad_enabled() and any(x.requires_grad for x in branches):
        return _PoolConcat.apply(int(pos), int(k), mode, *branches)
    return pool_concat_fwd(branches, int(pos), int(k), mode)


# ----------------------------------------------------- bias_grad_bf16

# XLA:CPU's tree-reduction rewrite cuts reduced dims above this size
XLA_REDUCE_WINDOW = 32


def xla_bias_sum_plan(dims: Sequence[int]
                      ) -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
    """The passes in which the reference's XLA:CPU build sums a bf16
    tensor over the reduced dims ``dims`` (read from its optimized HLO):
    while a reduced dim is larger than 32, a reduce-window pass cuts
    every such dim, zero-padded to a multiple of 32 (the pad split low
    = floor(pad / 2)), into windows of 32, and takes each smaller dim
    whole; a last pass sums what is left. Each pass is, per dim,
    ``(windows, window size, low pad)``; the last has one window per
    dim. Every window is summed in row-major order from +0, each add
    one bf16 rounding."""
    w = XLA_REDUCE_WINDOW
    dims = [int(d) for d in dims]
    passes = []
    while any(d > w for d in dims):
        step = tuple((-(-d // w), w, (-(-d // w) * w - d) // 2) if d > w
                     else (1, d, 0) for d in dims)
        passes.append(step)
        dims = [s[0] for s in step]
    passes.append(tuple((1, d, 0) for d in dims))
    return tuple(passes)


def _as_nbdc(dy: torch.Tensor) -> torch.Tensor:
    """A bias cotangent as (A, B, D, C): NHWC as it is, (N, C) as
    (1, 1, N, C) (a reduced dim of size 1 is a window of its own)."""
    if dy.dim() == 4:
        return dy
    if dy.dim() == 2:
        return dy[None, None]
    raise ValueError("bias_grad_bf16: dy must be NHWC or (N, C), got shape %s"
                     % (tuple(dy.shape),))


def bias_grad_bf16_plain(dy: torch.Tensor) -> torch.Tensor:
    """The float32 bias gradient of ``y + bias.to(bfloat16)`` from the
    bf16 cotangent ``dy`` (NHWC or (N, C)): the bf16 sum over every axis
    but the channel in XLA:CPU's order (:func:`xla_bias_sum_plan`),
    converted to float32 — the plain version of the bias_grad_bf16
    kernel. A bf16 tensor add is an f32 add rounded to bf16, the
    reference's bf16 add; a zero pad adds +0 to a sum that is never -0,
    so it is exact."""
    t = _as_nbdc(dy)
    for step in xla_bias_sum_plan(t.shape[:3]):
        pads = []
        for (n, w, lo), d in zip(reversed(step), reversed(t.shape[:3])):
            pads += [lo, n * w - d - lo]
        t = F.pad(t, [0, 0] + pads)
        (n0, w0, _), (n1, w1, _), (n2, w2, _) = step
        c = t.shape[3]
        # (n0, n1, n2, window elements in row-major order, C)
        t = t.reshape(n0, w0, n1, w1, n2, w2, c) \
            .permute(0, 2, 4, 1, 3, 5, 6).reshape(n0, n1, n2, -1, c)
        acc = torch.zeros((n0, n1, n2, c), dtype=torch.bfloat16,
                          device=t.device)
        for i in range(t.shape[3]):
            acc = acc + t[:, :, :, i]
        t = acc
    return t.reshape(-1).float()


def bias_grad_bf16(dy: torch.Tensor) -> torch.Tensor:
    """The float32 gradient of a bias added to a bf16 NHWC or (N, C)
    output, from its bf16 cotangent ``dy`` (read through its strides):
    the bf16 sum in the reference's order (:func:`bias_grad_bf16_plain`)
    as one call of ``csrc/bias_grad_bf16.cu`` (one launch per pass of
    the plan) for a CUDA tensor, the plain version for a CPU one."""
    if dy.dtype != torch.bfloat16:
        raise TypeError("bias_grad_bf16: dy must be bfloat16, got %s"
                        % dy.dtype)
    t = _as_nbdc(dy)
    if dy.device.type == "cpu":
        return bias_grad_bf16_plain(dy)
    _require_cuda(dy, "bias_grad_bf16")
    a, b, d, c = t.shape
    out = torch.empty(c, dtype=torch.float32, device=dy.device)
    if t.numel() == 0:
        return out.zero_()
    if max(t.shape) >= 2 ** 31:
        raise ValueError("bias_grad_bf16: shape %s exceeds the kernel's int "
                         "extents" % (tuple(dy.shape),))
    plan = xla_bias_sum_plan((a, b, d))
    flat = [v for step in plan
            for v in [s[0] for s in step] + [s[1] for s in step]
            + [s[2] for s in step]]
    # the largest pass's partials, twice (the passes ping-pong)
    most = max([math.prod(s[0] for s in step) for step in plan[:-1]]
               or [0]) * c
    scratch = torch.empty(max(2 * most, 2), dtype=torch.bfloat16,
                          device=dy.device)
    plan_arr = (ctypes.c_int * len(flat))(*flat)
    lib = _load("bias_grad_bf16")
    with torch.cuda.device(dy.device):
        err = lib.cxn_bias_grad_bf16(
            t.data_ptr(), *t.stride(), a, b, d, c, len(plan),
            ctypes.addressof(plan_arr), scratch.data_ptr(), scratch.numel(),
            out.data_ptr(), _stream(dy))
    _raise_on(err, "bias_grad_bf16")
    bias_grad_bf16.launches += 1
    return out


bias_grad_bf16.launches = 0


class _BiasAddBf16(torch.autograd.Function):
    """``y + bias.to(bfloat16)`` for a bf16 output ``y``, with the
    reference's gradient: ``dy`` through to y, and to the bias the bf16
    sum of :func:`bias_grad_bf16`, cast to the bias's dtype (float32 on
    the masters, bfloat16 on a ``grad_dtype = bfloat16`` shadow)."""

    @staticmethod
    def forward(ctx, y, bias):
        ctx.bias_dtype = bias.dtype
        return y + bias.to(torch.bfloat16)

    @staticmethod
    def backward(ctx, dy):
        db = bias_grad_bf16(dy).to(ctx.bias_dtype) \
            if ctx.needs_input_grad[1] else None
        return dy, db


def bias_add(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A conv's or fullc's bias add ``y + bias.to(y.dtype)`` over the
    last axis; on a bf16 ``y`` (``dtype = bfloat16``) through
    :class:`_BiasAddBf16`, so that the bias gradient sums in bf16 in the
    reference's order."""
    if y.dtype == torch.bfloat16:
        return _BiasAddBf16.apply(y, bias)
    return y + bias.to(y.dtype)


class _ScaleMulBf16(torch.autograd.Function):
    """``x * scale.to(bfloat16)`` for a bf16 ``x``, with the reference's
    gradient: ``dy * bf16(scale)`` to x, and to the scale the bf16 sum
    of ``bf16(dy * x)`` in XLA:CPU's order (:func:`bias_grad_bf16`),
    cast to the scale's dtype."""

    @staticmethod
    def forward(ctx, x, scale):
        s = scale.to(torch.bfloat16)
        ctx.scale_dtype = scale.dtype
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, dy):
        x, s = ctx.saved_tensors
        ds = bias_grad_bf16(dy * x).to(ctx.scale_dtype) \
            if ctx.needs_input_grad[1] else None
        return dy * s, ds


def scale_mul(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A per-channel scale ``x * scale.to(x.dtype)`` over the last axis
    (the plain batch-norm apply); on a bf16 ``x`` through
    :class:`_ScaleMulBf16`, so that the scale's gradient sums in bf16 in
    the reference's order, as :func:`bias_add`'s does."""
    if x.dtype == torch.bfloat16:
        return _ScaleMulBf16.apply(x, scale)
    return x * scale.to(x.dtype)


# ------------------------------------------------------------ counters

# launch counter name -> (wrapper, attribute). conv_epilogue's
# ``launches`` counts all its launches (the others subsets of it); the
# other kernels count float32 launches under their own name and
# bfloat16 ones under ``<name>_bf16``
_COUNTERS = {"conv_epilogue": (conv_epilogue, "launches"),
             "conv_epilogue_int32": (conv_epilogue, "launches_int32"),
             "conv_epilogue_bf16": (conv_epilogue, "launches_bf16"),
             "conv_epilogue_bwd": (conv_epilogue, "launches_bwd"),
             "conv_epilogue_bwd_bf16": (conv_epilogue, "launches_bwd_bf16"),
             "bn_apply_fwd": (bn_apply_fwd, "launches"),
             "bn_apply_fwd_bf16": (bn_apply_fwd, "launches_bf16"),
             "bn_apply_bwd": (bn_apply_bwd, "launches"),
             "bn_apply_bwd_bf16": (bn_apply_bwd, "launches_bf16"),
             "matmul": (matmul_kernel, "launches"),
             "matmul_bf16": (matmul_kernel, "launches_bf16"),
             "relu_max_pool_fwd": (relu_max_pool_fwd, "launches"),
             "relu_max_pool_fwd_bf16": (relu_max_pool_fwd, "launches_bf16"),
             "relu_max_pool_bwd": (relu_max_pool_bwd, "launches"),
             "relu_max_pool_bwd_bf16": (relu_max_pool_bwd, "launches_bf16"),
             "pool_concat_fwd": (pool_concat_fwd, "launches"),
             "pool_concat_fwd_bf16": (pool_concat_fwd, "launches_bf16"),
             "pool_concat_bwd": (pool_concat_bwd, "launches"),
             "pool_concat_bwd_bf16": (pool_concat_bwd, "launches_bf16"),
             "bias_grad_bf16": (bias_grad_bf16, "launches")}


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counter."""
    restore_launch_counts({name: 0 for name in _COUNTERS})
    relu_max_pool_bwd.strided_dy = 0


def restore_launch_counts(counts: Dict[str, int]) -> None:
    """Set the counters to ``counts`` (as :func:`launch_counts` gave
    them), e.g. after launches that checked or timed a kernel."""
    for name, n in counts.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, n)


def launch_counts() -> Dict[str, int]:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _COUNTERS.items()}
