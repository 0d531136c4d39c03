#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (cxxnet_tpu_torch/).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase prints ``"ok": false`` and
the script exits non-zero without a result line):

1. env     — the card (``nvidia-smi`` name and power limit), torch and
             CUDA versions, and the ``nvcc`` build of every kernel from
             ``cxxnet_tpu_torch/csrc/`` (one ``nvcc`` per source, all
             started together).
2. kernels — each kernel against its plain PyTorch version on the card,
             at every shape its path gives it: ``conv_epilogue`` at the
             served Inception-BN-224's bucket-128 shapes (plus dtype,
             layout and ragged-channel cases); ``bn_apply`` forward
             (bit-exact) and backward (dx bit-exact, channel sums within
             rtol 1e-5 of the sum of their terms' magnitudes) at every
             batch-norm shape of the batch-128 training step; ``matmul``
             at fc1's three products and a ragged case (within rtol
             1e-5 of sum |a*b|); ``relu_max_pool`` forward and backward
             (both bit-exact, NaN positions included) at kaiming-224's
             three fused pools at batch 128 on inputs in steps of 0.5
             (tied maxima), with the cotangent also as a permuted view,
             plus a ragged-channel (C = 3) and a NaN case. Max error,
             kernel / plain / library times (CUDA events) and the bound
             from bytes and operations; for relu_max_pool, in place of a
             library call, F.relu + F.max_pool2d and their autograd
             backward (two calls, and a backward that credits one tie).
3. serve   — Inception-BN-224 (1000 classes, random weights from a seed,
             realistic BN running stats) saved as a snapshot, served
             through ``ServeSession(device="cuda")`` to closed-loop
             clients and one full-bucket burst; launch counts show the
             path went through the kernels; 4 rows are held against the
             port on the CPU.
4. train   — Inception-BN-224 with fc1 declared ``pallas_fullc`` and
             ``bn_pallas = bn_fuse_relu = 1``, seeded weights, batch 128:
             2 warm and 10 timed ``NetTrainer.update`` steps on one
             batch (step time by CUDA events and host clock, img/s,
             TFLOP/s, peak memory, the loss of every step, which must be
             finite and fall); exactly 69 bn_apply forward, 69 backward,
             3 matmul and 0 conv_epilogue launches per step; a profiled
             step (medians over 5 profiled steps: top kernels, time by
             kind, idle share); then one update at batch 4 from the
             same weights on the card and on the CPU: the loss within
             rtol 1e-5; every parameter's update in float64 on the card
             within 1e-3 of the CPU's, and through the kernels within
             1e-3 of the card's plain path (``update_delta_check`` says
             why float32 updates are not held to the CPU's); and every
             pool's backward on the card against the CPU's at batch 8
             (max: every tie credited to the same element; avg: within
             rtol 1e-5).
5. train_kaiming — kaiming-224 (model J', ``fused_pools``, ``pallas_pool =
             1``, dropout 0.5 on fc1 and fc2), seeded weights, batch 128:
             2 warm and 10 timed ``update`` steps as in phase 4; exactly 3
             relu_max_pool forward and 3 backward launches per step and
             none of the other kernels; the loss finite and falling; a
             profiled step; the batch-4 update check of phase 4 with the
             same dropout masks injected on the card and on the CPU (the
             plain path is ``pallas_pool = 0``: relu, then max pooling);
             and the SPP max pools' backward against the CPU's.

Then a ``kernels`` line (every ported kernel with its launches, error
and times), the ``nvidia-smi`` line, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BUCKETS = "1,4,16,64,128"
MAX_BATCH = 128
KNOBS = [("bn_fold_eval", "1"), ("bn_fuse_relu", "1"),
         ("conv_pallas_epilogue", "1")]
EPILOGUE = {"name": "conv_epilogue", "route": "cuda",
            "source": "cxxnet_tpu_torch/csrc/conv_epilogue.cu",
            "replaces": "cxxnet_tpu/layers/pallas_kernels.py:327"}
BN_FWD = {"name": "bn_apply_fwd", "route": "cuda",
          "source": "cxxnet_tpu_torch/csrc/bn_apply.cu",
          "replaces": "cxxnet_tpu/layers/pallas_kernels.py:247"}
BN_BWD = {"name": "bn_apply_bwd", "route": "cuda",
          "source": "cxxnet_tpu_torch/csrc/bn_apply.cu",
          "replaces": "cxxnet_tpu/layers/pallas_kernels.py:310"}
MATMUL = {"name": "matmul", "route": "cuda",
          "source": "cxxnet_tpu_torch/csrc/matmul.cu",
          "replaces": "cxxnet_tpu/layers/pallas_kernels.py:35"}
RMP_FWD = {"name": "relu_max_pool_fwd", "route": "cuda",
           "source": "cxxnet_tpu_torch/csrc/relu_max_pool.cu",
           "replaces": "cxxnet_tpu/layers/pallas_kernels.py:91"}
RMP_BWD = {"name": "relu_max_pool_bwd", "route": "cuda",
           "source": "cxxnet_tpu_torch/csrc/relu_max_pool.cu",
           "replaces": "cxxnet_tpu/layers/pallas_kernels.py:107"}
NCLASS = 1000
DEVICE = "cuda"
TRAIN_BATCH = 128
TRAIN_KNOBS = [("bn_pallas", "1"), ("bn_fuse_relu", "1")]
WARM_STEPS, TIMED_STEPS = 2, 10
# per training step of Inception-BN-224: launches each wrapper must count
TRAIN_LAUNCHES = {"bn_apply_fwd": 69, "bn_apply_bwd": 69, "matmul": 3,
                  "conv_epilogue": 0, "relu_max_pool_fwd": 0,
                  "relu_max_pool_bwd": 0}
# per training step of kaiming-224 with fused_pools and pallas_pool = 1
KAIMING_LAUNCHES = {"bn_apply_fwd": 0, "bn_apply_bwd": 0, "matmul": 0,
                    "conv_epilogue": 0, "relu_max_pool_fwd": 3,
                    "relu_max_pool_bwd": 3}
# channel sums and matmul outputs: error against rtol * sum |terms|
SUM_RTOL = 1e-5
# one update at batch 4, per parameter: the card's float64 update
# against the CPU's, and the kernels against the card's plain path
UPDATE_RTOL = 1e-3
LOSS_RTOL = 1e-5
# serve results held against the port on the CPU (TF32 off on the card)
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4

# published peaks (NVIDIA data sheets): HBM bytes/s and float32 FLOP/s
# outside the tensor cores, by part
_PEAKS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
          ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops, key
    return 3.35e12, 67e12, "H100 SXM (assumed)"


def nvidia_smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    res = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % res.stderr.strip())
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events
    around the whole run, after ``warmup`` calls)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def inception_cfg():
    from cxxnet_tpu_torch.models import inception_bn
    from cxxnet_tpu_torch.utils.config import parse_config
    return parse_config(inception_bn(nclass=1000, batch_size=MAX_BATCH,
                                     image_size=224)) + KNOBS + [
        ("seed", str(SEED)), ("serve_buckets", BUCKETS),
        ("serve_max_delay_ms", "2")]


# ------------------------------------------------------------- phase 1


def phase_env():
    import torch
    from cxxnet_tpu_torch.layers import kernels
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    paths = kernels.build_kernels()
    build_s = time.perf_counter() - t0
    build = {"wall_s": round(build_s, 3)}
    for name, path in paths.items():
        info = kernels.build_info[name]
        build[name] = {"so": os.path.relpath(path),
                       "seconds": round(float(info["seconds"]), 3),
                       "ptxas": [ln.strip() for ln in
                                 str(info["log"]).splitlines()
                                 if "Used" in ln and "registers" in ln
                                 or "spill" in ln and " 0 bytes spill"
                                 not in ln][:12]}
    emit({"phase": "env", "ok": True, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build": build})
    return smi


# ------------------------------------------------------------- phase 2


def _configured(cfg):
    from cxxnet_tpu_torch.graph import NetGraph
    g = NetGraph()
    g.configure(cfg)
    return g


def path_epilogue_shapes(net, batch: int):
    """(B, H, W, C) of every conv_epilogue launch of one eval forward:
    the outputs of the convs the bn_fold_eval pass pairs with a BN."""
    shapes = []
    for li in sorted(net.fold_pairs):
        s = net.layer_objs[li].out_shapes[0]
        shapes.append((batch, s.y, s.x, s.ch))
    return shapes


def epilogue_case(shape, in_dtype, out_dtype, relu: bool, bw: float,
                  flops: float):
    """One conv_epilogue case on the card: kernel vs plain version on
    the same inputs, with times and the bound."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape))
    c = shape[-1]
    n = int(np.prod(shape))
    in_b = torch.finfo(in_dtype).bits // 8
    out_b = torch.finfo(out_dtype).bits // 8
    nbytes = n * (in_b + out_b) + 8 * c
    # enough distinct input buffers that a run of launches streams from
    # device memory, not from the 50 MB L2
    nbuf = int(min(32, max(1, -(-200e6 // (n * in_b)))))
    xs = [torch.randn(shape, generator=gen, device=dev).to(in_dtype)
          for _ in range(nbuf)]
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    shift = torch.randn(c, generator=gen, device=dev)
    launches0 = kernels.conv_epilogue.launches
    got = kernels.conv_epilogue(xs[0], scale, shift, relu, out_dtype)
    ref = kernels.conv_epilogue_plain(xs[0], scale, shift, relu, out_dtype)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    # one ulp of the output type at the output's magnitude
    tol = float(torch.finfo(out_dtype).eps) \
        * max(1.0, float(ref.float().abs().max()))
    bound_ms = max(nbytes / bw, 3.0 * n / flops) * 1e3
    out = {"shape": list(shape), "in": str(in_dtype)[6:],
           "out": str(out_dtype)[6:], "relu": relu,
           "max_abs_err": err, "tol": tol, "ok": err <= tol,
           "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": "bytes" if nbytes / bw >= 3.0 * n / flops
           else "operations"}
    iters = int(min(200, max(10, 4e9 // nbytes)))
    out["ms"] = cuda_time_ms(
        lambda i: kernels.conv_epilogue(xs[i % nbuf], scale, shift, relu,
                                        out_dtype), iters)
    out["plain_ms"] = cuda_time_ms(
        lambda i: kernels.conv_epilogue_plain(xs[i % nbuf], scale, shift,
                                              relu, out_dtype), iters)
    # one PyTorch call computes the relu-free f32 case: addcmul
    out["library_ms"] = None
    if not relu and in_dtype == out_dtype == torch.float32:
        out["library_ms"] = cuda_time_ms(
            lambda i: torch.addcmul(shift, xs[i % nbuf], scale), iters)
    # comparison and timing launches are not main-path launches
    kernels.conv_epilogue.launches = launches0
    del xs, got, ref
    torch.cuda.empty_cache()
    return out


def train_cfg(batch: int):
    """Inception-BN-224 as the training slice runs it: fc1 declared
    ``pallas_fullc`` (the same function as ``fullc``), BN through the
    bn_apply kernel with the relu fused."""
    from cxxnet_tpu_torch.models import inception_bn
    from cxxnet_tpu_torch.utils.config import parse_config
    text = inception_bn(nclass=NCLASS, batch_size=batch, image_size=224)
    return parse_config(text.replace("fullc:fc1", "pallas_fullc:fc1")) \
        + TRAIN_KNOBS + [("seed", str(SEED))]


def path_bn_shapes(net, batch: int):
    """Shape of every bn_apply launch of one training forward (and so of
    every backward launch): the input of each batch-norm layer."""
    shapes = []
    for li, info in enumerate(net.graph.layers):
        if info.type in ("batch_norm", "pallas_batch_norm"):
            s = net.layer_objs[li].out_shapes[0]
            shapes.append((batch, s.x) if s.is_mat
                          else (batch, s.y, s.x, s.ch))
    return shapes


def path_matmul_products(net, batch: int):
    """(M, K, N, A transposed, B transposed) of every matmul launch of
    one training step: per pallas_fullc layer the forward x.w, and the
    backward dy.w^T and x^T.dy (transposed operands are strided views)."""
    out = []
    for li in range(len(net.graph.layers)):
        if net.graph.effective_type(li) == "pallas_fullc":
            p = net.layer_objs[li].param
            m, k, n = batch, p.num_input_node, p.num_hidden
            out += [(m, k, n, False, False), (m, n, k, False, True),
                    (k, m, n, True, False)]
    return out


def bound(nbytes: float, ops: float, bw: float, flops: float):
    """(bound ms, what bounds it) of a function moving ``nbytes`` and
    doing ``ops`` float32 operations."""
    return max(nbytes / bw, ops / flops) * 1e3, \
        "bytes" if nbytes / bw >= ops / flops else "operations"


def bn_case(shape, bw: float, flops: float):
    """bn_apply forward and backward (relu fused, as on the path) on the
    card against their plain versions on the same inputs, with times
    and bounds. Forward and dx must agree bit for bit; each channel sum
    within SUM_RTOL of the sum of its terms' magnitudes (the f32 sums
    run in another order than torch.sum's)."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape))
    c = shape[-1]
    n = int(np.prod(shape))
    nbuf = int(min(16, max(1, -(-200e6 // (n * 4)))))
    xs = [torch.randn(shape, generator=gen, device=dev) for _ in range(nbuf)]
    dys = [torch.randn(shape, generator=gen, device=dev)
           for _ in range(nbuf)]
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    shift = 0.5 * torch.randn(c, generator=gen, device=dev)
    counts0 = kernels.launch_counts()
    y = kernels.bn_apply_fwd(xs[0], scale, shift, True)
    yp = kernels.bn_apply_plain(xs[0], scale, shift, True)
    dx, ds, dt = kernels.bn_apply_bwd(xs[0], y, dys[0], scale, True)
    px, ps, pt = kernels.bn_apply_bwd_plain(xs[0], yp, dys[0], scale, True)
    axes = tuple(range(len(shape) - 1))
    dym = torch.where(yp > 0, dys[0], torch.zeros_like(dys[0]))
    mag_s = (dym * xs[0]).abs().sum(axes)
    mag_t = dym.abs().sum(axes)
    torch.cuda.synchronize()
    es, et = (ds - ps).abs(), (dt - pt).abs()
    out = {"shape": list(shape),
           "fwd_err": float((y - yp).abs().max()),
           "dx_err": float((dx - px).abs().max()),
           "sum_err": float(max(es.max(), et.max())),
           "sum_rel": float(max((es / mag_s.clamp_min(1e-30)).max(),
                                (et / mag_t.clamp_min(1e-30)).max()))}
    out["ok"] = bool(out["fwd_err"] == 0.0 and out["dx_err"] == 0.0
                     and bool((es <= SUM_RTOL * mag_s).all())
                     and bool((et <= SUM_RTOL * mag_t).all()))
    del yp, dx, px, dym, ds, dt, ps, pt
    # forward: read x, write y (+ scale, shift); mul, add, max each
    out["fwd_bound_ms"], out["fwd_bound_by"] = bound(8 * n + 8 * c, 3 * n,
                                                     bw, flops)
    # backward: read x, y, dy, write dx (+ scale, two sums); select,
    # mul, add 0, mul, two adds each
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(16 * n + 12 * c, 6 * n,
                                                     bw, flops)
    ys = [kernels.bn_apply_fwd(x, scale, shift, True) for x in xs]
    iters = int(min(200, max(10, 4e9 // (8 * n))))
    out["fwd_ms"] = cuda_time_ms(
        lambda i: kernels.bn_apply_fwd(xs[i % nbuf], scale, shift, True),
        iters)
    out["fwd_plain_ms"] = cuda_time_ms(
        lambda i: kernels.bn_apply_plain(xs[i % nbuf], scale, shift, True),
        iters)
    out["bwd_ms"] = cuda_time_ms(
        lambda i: kernels.bn_apply_bwd(xs[i % nbuf], ys[i % nbuf],
                                       dys[i % nbuf], scale, True), iters)
    out["bwd_plain_ms"] = cuda_time_ms(
        lambda i: kernels.bn_apply_bwd_plain(xs[i % nbuf], ys[i % nbuf],
                                             dys[i % nbuf], scale, True),
        iters)
    # comparison and timing launches are not main-path launches
    kernels.bn_apply_fwd.launches = counts0["bn_apply_fwd"]
    kernels.bn_apply_bwd.launches = counts0["bn_apply_bwd"]
    del xs, dys, ys, y
    torch.cuda.empty_cache()
    return out


def matmul_case(m: int, k: int, n: int, ta: bool, tb: bool, bw: float,
                flops: float):
    """The matmul kernel on the card against its plain version (and
    torch.matmul, the library call) for an (M, K) . (K, N) product whose
    operands may be transposed views; every output within SUM_RTOL of
    sum_k |a * b|."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + m + 3 * k + 7 * n)
    a = torch.randn((k, m) if ta else (m, k), generator=gen, device=dev)
    b = torch.randn((n, k) if tb else (k, n), generator=gen, device=dev)
    A, B = (a.t() if ta else a), (b.t() if tb else b)
    counts0 = kernels.launch_counts()
    got = kernels.matmul_kernel(A, B)
    ref = kernels.matmul_plain(A, B)
    mag = torch.matmul(A.abs(), B.abs())
    torch.cuda.synchronize()
    err = (got - ref).abs()
    out = {"mkn": [m, k, n], "a_transposed": ta, "b_transposed": tb,
           "max_abs_err": float(err.max()),
           "rel_err": float((err / mag.clamp_min(1e-30)).max()),
           "ok": bool((err <= SUM_RTOL * mag).all())}
    out["bound_ms"], out["bound_by"] = bound(
        4 * (m * k + k * n + m * n), 2 * m * n * k, bw, flops)
    out["ms"] = cuda_time_ms(lambda i: kernels.matmul_kernel(A, B), 50)
    out["plain_ms"] = cuda_time_ms(lambda i: kernels.matmul_plain(A, B), 50)
    out["library_ms"] = cuda_time_ms(lambda i: torch.matmul(A, B), 50)
    kernels.matmul_kernel.launches = counts0["matmul"]
    return out


def kaiming_cfg(batch: int, pallas_pool: int = 1):
    """kaiming-224 (model J') as the kaiming training slice runs it:
    ``fused_pools``, so three relu_max_pooling layers, through the
    relu_max_pool kernels under ``pallas_pool = 1``."""
    from cxxnet_tpu_torch.models import kaiming
    from cxxnet_tpu_torch.utils.config import parse_config
    text = kaiming(nclass=NCLASS, batch_size=batch, image_size=224,
                   fused_pools=True)
    return parse_config(text) + [("pallas_pool", str(pallas_pool)),
                                 ("seed", str(SEED))]


def path_relu_pool_shapes(net, batch: int):
    """(B, H, W, C, k) of every relu_max_pool launch of one training
    forward (and so of every backward launch): the input of each
    relu_max_pooling layer that the kernels take."""
    from cxxnet_tpu_torch.layers.conv import relu_max_pool_applicable
    out = []
    for layer in net.layer_objs:
        p = getattr(layer, "param", None)
        if (getattr(layer, "pre_relu", False) and layer.mode == "max"
                and (layer.use_pallas or p.pallas_pool)
                and relu_max_pool_applicable(p)):
            s = layer.in_shapes[0]
            out.append((batch, s.y, s.x, s.ch, p.kernel_height))
    return out


def same_bits(a, b) -> bool:
    """Equal values and NaN at the same places."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)
                and torch.equal(torch.where(na, 0.0, a),
                                torch.where(nb, 0.0, b)))


def max_err(a, b) -> float:
    """Largest |a - b| where neither is NaN; inf if NaN places differ."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return float("inf")
    d = (torch.where(na, 0.0, a) - torch.where(nb, 0.0, b)).abs()
    return float(d.max()) if d.numel() else 0.0


def relu_pool_case(shape, k: int, bw: float, flops: float,
                   nan: bool = False, timed: bool = True):
    """relu_max_pool forward and backward on the card against their
    plain versions on the same inputs, bit for bit: x in steps of 0.5
    (positive windows hold tied maxima, every one credited), the
    backward also with the cotangent as a permuted view (read through
    its strides). With ``timed``: kernel, plain and reference times
    (F.relu + F.max_pool2d, and their autograd backward) and the
    bounds."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape) + k)
    b, h, w, c = shape
    oshape = (b, h - k + 1, w - k + 1, c)
    n_in, n_out = int(np.prod(shape)), int(np.prod(oshape))
    nbuf = int(min(8, max(1, -(-200e6 // (4 * n_in))))) if timed else 1
    xs = [torch.round(2 * torch.randn(shape, generator=gen, device=dev)) / 2
          for _ in range(nbuf)]
    if nan:
        xs[0].view(-1)[::997] = float("nan")
    dys = [torch.randn(oshape, generator=gen, device=dev)
           for _ in range(nbuf)]
    counts0 = kernels.launch_counts()
    strided0 = kernels.relu_max_pool_bwd.strided_dy
    y = kernels.relu_max_pool_fwd(xs[0], k)
    yp = kernels.relu_max_pool_plain(xs[0], k)
    dx = kernels.relu_max_pool_bwd(xs[0], y, dys[0], k)
    dxp = kernels.relu_max_pool_bwd_plain(xs[0], yp, dys[0], k)
    dyv = dys[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    dxv = kernels.relu_max_pool_bwd(xs[0], y, dyv, k)
    # credits beyond one per positive window: how many ties the
    # backward resolved
    r = torch.clamp_min(xs[0], 0)
    pos = yp > 0
    credits = sum(int(((r[:, di:di + oshape[1], dj:dj + oshape[2]] == yp)
                       & pos).sum()) for di in range(k) for dj in range(k))
    torch.cuda.synchronize()
    out = {"shape": list(shape), "k": k, "nan": nan,
           "fwd_err": max_err(y, yp), "bwd_err": max_err(dx, dxp),
           "bwd_strided_dy_err": max_err(dxv, dxp),
           "fwd_exact": same_bits(y, yp),
           "bwd_exact": same_bits(dx, dxp) and same_bits(dxv, dxp),
           "tie_credits": credits - int(pos.sum()),
           "nan_outputs": int(torch.isnan(y).sum())}
    out["ok"] = out["fwd_exact"] and out["bwd_exact"]
    del yp, dx, dxp, dyv, dxv, r, pos
    if timed:
        # forward: read x, write y; k*k maxima per output. backward: read
        # x, y, dy, write dx; k*k compares and adds per input
        out["fwd_bound_ms"], out["fwd_bound_by"] = bound(
            4 * (n_in + n_out), k * k * n_out, bw, flops)
        out["bwd_bound_ms"], out["bwd_bound_by"] = bound(
            8 * (n_in + n_out), 2 * k * k * n_in, bw, flops)
        ys = [kernels.relu_max_pool_fwd(x, k) for x in xs]
        iters = int(min(40, max(5, 2e9 // (4 * (n_in + n_out)))))
        out["fwd_ms"] = cuda_time_ms(
            lambda i: kernels.relu_max_pool_fwd(xs[i % nbuf], k), iters)
        out["fwd_plain_ms"] = cuda_time_ms(
            lambda i: kernels.relu_max_pool_plain(xs[i % nbuf], k), iters)
        out["bwd_ms"] = cuda_time_ms(
            lambda i: kernels.relu_max_pool_bwd(xs[i % nbuf], ys[i % nbuf],
                                                dys[i % nbuf], k), iters)
        out["bwd_plain_ms"] = cuda_time_ms(
            lambda i: kernels.relu_max_pool_bwd_plain(
                xs[i % nbuf], ys[i % nbuf], dys[i % nbuf], k), iters)
        del ys

        def ref_fwd(x):
            return F.max_pool2d(F.relu(x.permute(0, 3, 1, 2)), k, 1)
        out["reference_fwd_ms"] = cuda_time_ms(
            lambda i: ref_fwd(xs[i % nbuf]), iters)
        leaves = [x.clone().requires_grad_(True) for x in xs]
        graphs = [ref_fwd(x) for x in leaves]
        dys_nchw = [d.permute(0, 3, 1, 2) for d in dys]
        out["reference_bwd_ms"] = cuda_time_ms(
            lambda i: torch.autograd.grad(graphs[i % nbuf],
                                          [leaves[i % nbuf]],
                                          dys_nchw[i % nbuf],
                                          retain_graph=True), iters)
        del leaves, graphs, dys_nchw
    # comparison and timing launches are not main-path launches
    kernels.relu_max_pool_fwd.launches = counts0["relu_max_pool_fwd"]
    kernels.relu_max_pool_bwd.launches = counts0["relu_max_pool_bwd"]
    kernels.relu_max_pool_bwd.strided_dy = strided0
    del xs, dys, y
    torch.cuda.empty_cache()
    return out


def relu_pool_section(bw: float, flops: float):
    """Every relu_max_pool shape of kaiming-224's batch-128 training
    step, plus a ragged-channel and a NaN case."""
    from cxxnet_tpu_torch.nnet.net import FuncNet
    knet = FuncNet(_configured(kaiming_cfg(TRAIN_BATCH)), TRAIN_BATCH)
    shapes = path_relu_pool_shapes(knet, TRAIN_BATCH)
    if len(shapes) != KAIMING_LAUNCHES["relu_max_pool_fwd"]:
        raise RuntimeError("expected %d fused pools, the net has %d"
                           % (KAIMING_LAUNCHES["relu_max_pool_fwd"],
                              len(shapes)))
    path = [relu_pool_case(s[:4], s[4], bw, flops) for s in shapes]
    extra = [relu_pool_case((TRAIN_BATCH, 37, 37, 3), 3, bw, flops,
                            timed=False),
             relu_pool_case((16, 18, 18, 256), 3, bw, flops, nan=True,
                            timed=False),
             relu_pool_case((8, 9, 9, 12), 2, bw, flops, timed=False)]
    keys = ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "reference_fwd_ms",
            "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "reference_bwd_ms")
    cases = path + extra
    return {"ok": all(c["ok"] for c in cases),
            "launches_per_step": len(path),
            "step_sum": {k: sum(c[k] for c in path) for k in keys},
            "fwd_max_abs_err": max(c["fwd_err"] for c in cases),
            "bwd_max_abs_err": max(max(c["bwd_err"], c["bwd_strided_dy_err"])
                                   for c in cases),
            "fwd_bound_by": "bytes" if all(c["fwd_bound_by"] == "bytes"
                                           for c in path) else "operations",
            "bwd_bound_by": "bytes" if all(c["bwd_bound_by"] == "bytes"
                                           for c in path) else "operations",
            "reference": "F.relu + F.max_pool2d (two calls; its backward "
                         "credits one tied maximum per window)",
            "path_cases": path, "extra_cases": extra}


def phase_kernels(bw: float, flops: float):
    import torch
    from cxxnet_tpu_torch.nnet.net import FuncNet
    net = FuncNet(_configured(inception_cfg()), MAX_BATCH)
    shapes = path_epilogue_shapes(net, MAX_BATCH)
    if len(shapes) != 69:
        raise RuntimeError("expected 69 epilogue launches per forward, "
                           "the net has %d" % len(shapes))
    f32, bf16 = torch.float32, torch.bfloat16
    per_shape = {}
    for s in sorted(set(shapes), key=lambda s: -int(np.prod(s))):
        per_shape[s] = epilogue_case(s, f32, f32, True, bw, flops)
    fwd = {k: sum(per_shape[s][k] for s in shapes)
           for k in ("ms", "plain_ms", "bound_ms", "bytes")}
    stem = max(shapes, key=lambda s: int(np.prod(s)))
    extra = [
        epilogue_case(stem, bf16, bf16, True, bw, flops),
        epilogue_case(stem, f32, bf16, True, bw, flops),
        epilogue_case(stem, f32, f32, False, bw, flops),
        epilogue_case((MAX_BATCH, 1000), f32, f32, False, bw, flops),
        epilogue_case((MAX_BATCH, 1024), f32, f32, True, bw, flops),
        epilogue_case((MAX_BATCH, 28, 28, 67), f32, f32, True, bw, flops),
        epilogue_case((MAX_BATCH, 28, 28, 67), bf16, f32, False, bw, flops),
        epilogue_case((MAX_BATCH, 14, 14, 6), f32, f32, True, bw, flops),
    ]
    cases = list(per_shape.values()) + extra
    ok = all(c["ok"] for c in cases)
    # the training step's kernels, at its shapes (batch 128)
    tnet = FuncNet(_configured(train_cfg(TRAIN_BATCH)), TRAIN_BATCH)
    bn_shapes = path_bn_shapes(tnet, TRAIN_BATCH)
    if len(bn_shapes) != TRAIN_LAUNCHES["bn_apply_fwd"]:
        raise RuntimeError("expected %d batch norms, the net has %d"
                           % (TRAIN_LAUNCHES["bn_apply_fwd"],
                              len(bn_shapes)))
    bn_cases = {}
    for s in sorted(set(bn_shapes), key=lambda s: -int(np.prod(s))):
        bn_cases[s] = bn_case(s, bw, flops)
    bn_step = {k: sum(bn_cases[s][k] for s in bn_shapes)
               for k in ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms",
                         "bwd_ms", "bwd_plain_ms", "bwd_bound_ms")}
    products = path_matmul_products(tnet, TRAIN_BATCH)
    if len(products) != TRAIN_LAUNCHES["matmul"]:
        raise RuntimeError("expected %d matmul launches per step, the net "
                           "has %d" % (TRAIN_LAUNCHES["matmul"],
                                       len(products)))
    mm_path = [matmul_case(*p, bw, flops) for p in products]
    mm_extra = [matmul_case(77, 1000, 129, False, True, bw, flops)]
    mm_step = {k: sum(c[k] for c in mm_path)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bn_ok = all(c["ok"] for c in bn_cases.values())
    mm_ok = all(c["ok"] for c in mm_path + mm_extra)
    rmp = relu_pool_section(bw, flops)
    ok = ok and bn_ok and mm_ok and rmp["ok"]
    res = {"phase": "kernels", "ok": ok, "kernel": "conv_epilogue",
           "path_launches_per_forward": len(shapes),
           "distinct_path_shapes": len(per_shape),
           "forward_sum": fwd,
           "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                      for c in per_shape.values())
           else "operations",
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "path_cases": [dict(c, count=shapes.count(tuple(c["shape"])))
                          for c in per_shape.values()],
           "extra_cases": extra,
           "bn_apply": {
               "ok": bn_ok, "launches_per_step": len(bn_shapes),
               "distinct_path_shapes": len(bn_cases), "step_sum": bn_step,
               "fwd_max_abs_err": max(c["fwd_err"]
                                      for c in bn_cases.values()),
               "bwd_max_abs_err": max(max(c["dx_err"], c["sum_err"])
                                      for c in bn_cases.values()),
               "bwd_sum_max_rel": max(c["sum_rel"]
                                      for c in bn_cases.values()),
               "sum_rtol": SUM_RTOL,
               "fwd_bound_by": "bytes" if all(
                   c["fwd_bound_by"] == "bytes" for c in bn_cases.values())
               else "operations",
               "bwd_bound_by": "bytes" if all(
                   c["bwd_bound_by"] == "bytes" for c in bn_cases.values())
               else "operations",
               "cases": [dict(c, count=bn_shapes.count(tuple(c["shape"])))
                         for c in bn_cases.values()]},
           "matmul": {
               "ok": mm_ok, "launches_per_step": len(products),
               "step_sum": mm_step,
               "max_abs_err": max(c["max_abs_err"]
                                  for c in mm_path + mm_extra),
               "max_rel_err": max(c["rel_err"] for c in mm_path + mm_extra),
               "rtol": SUM_RTOL,
               "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                          for c in mm_path)
               else "operations",
               "path_cases": mm_path, "extra_cases": mm_extra},
           "relu_max_pool": rmp}
    emit(res)
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version")
    return res


# ------------------------------------------------------------- phase 3


def calibrate_bn(trainer, data) -> None:
    """Set every BN's running stats to the batch moments of its input on
    ``data`` (a trained BN's statistics), BN by BN in graph order, with
    the eval fold switched off so the conv outputs arrive raw."""
    import torch
    net, g = trainer.net, trainer.graph
    net.bn_fold_eval = False
    try:
        with torch.no_grad():
            for li, info in enumerate(g.layers):
                if info.type != "batch_norm":
                    continue
                nodes, _, _ = net.forward(trainer.params, trainer.net_state,
                                          data)
                x = nodes[info.nindex_in[0]].float()
                dims = tuple(range(x.dim() - 1))
                st = trainer.net_state[g.layer_key(li)]
                st["running_exp"].copy_(x.mean(dims))
                st["running_var"].copy_(
                    x.var(dims, unbiased=False).clamp_min(1e-3))
    finally:
        net.bn_fold_eval = True


def profile_forward(t, data, nodes, reps: int = 3):
    """torch.profiler over ``reps`` eval forwards of a resident batch:
    device time per forward by kernel name, the device's busy and idle
    share of the window, and the conv_epilogue kernel's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t.pred(data, nodes)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(reps):
            t.pred(data, nodes)
        b.record()
        torch.cuda.synchronize()
    wall = a.elapsed_time(b) / reps
    by_name = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        e = by_name.setdefault(evt.name, [0.0, 0])
        e[0] += evt.time_range.elapsed_us() / 1e3 / reps
        e[1] += 1
    busy = sum(v[0] for v in by_name.values())
    epi = [v for k, v in by_name.items() if "epilogue_" in k]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall) if busy else None,
            "epilogue_device_ms": sum(v[0] for v in epi) if epi else None,
            "epilogue_launches": sum(v[1] for v in epi) / reps,
            "kernels_per_forward": sum(v[1] for v in by_name.values())
            / reps,
            "top": [{"name": k[:90], "ms": v[0], "n": v[1] / reps}
                    for k, v in top]}


def images(rng, n: int) -> np.ndarray:
    """Seeded 224x224 RGB inputs with per-image contrast and offset."""
    base = rng.randn(n, 224, 224, 3).astype(np.float32)
    return base * rng.uniform(0.2, 3.0, (n, 1, 1, 3)).astype(np.float32) \
        + 2 * rng.randn(n, 1, 1, 3).astype(np.float32)


class Recorder:
    """In-memory telemetry sink for the serve batcher's records."""

    enabled = True

    def __init__(self):
        self.records = []

    def emit(self, kind: str, **fields) -> None:
        self.records.append(dict(fields, kind=kind, t=time.monotonic()))


def tail_report(records, t0: float, n: int = 6):
    """Exact request-latency percentiles of a drive (with how many
    samples lie beyond each), and its slowest requests and batches with
    when they happened (seconds after ``t0``)."""
    reqs = [r for r in records if r["kind"] == "serve_request"]
    bats = [r for r in records if r["kind"] == "serve_batch"]
    slow = sorted(reqs, key=lambda r: -r["latency_ms"])[:n]
    dev = sorted(r["device_ms"] for r in bats)
    lat = np.array([r["latency_ms"] for r in reqs])
    pct = {"p%d" % q: {"ms": float(np.percentile(lat, q)),
                       "beyond": int(np.sum(lat > np.percentile(lat, q)))}
           for q in (50, 90, 99)} if len(lat) else {}
    return {
        "requests": len(reqs), "batches": len(bats),
        "latency": pct,
        "batch_rows_mean": float(np.mean([r["rows"] for r in bats]))
        if bats else None,
        "slowest_requests": [{"at_s": r["t"] - t0,
                              "latency_ms": r["latency_ms"],
                              "queue_ms": r["queue_ms"],
                              "rows": r["rows"]} for r in slow],
        "batch_device_ms_p50": dev[len(dev) // 2] if dev else None,
        "slowest_batches": [{"at_s": r["t"] - t0, "batch": r["batch"],
                             "device_ms": r["device_ms"],
                             "queue_ms": r["queue_ms"], "rows": r["rows"],
                             "bucket": r["bucket"]}
                            for r in sorted(bats,
                                            key=lambda r: -r["device_ms"])
                            [:n]]}


def phase_serve(workdir: str):
    import torch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import ServeSession, run_closed_loop
    cfg = inception_cfg()
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    init = NetTrainer(cfg, device="cuda")
    init.init_model()
    # realistic running stats: the reference's zero init folds to a
    # ~1e5 scale that overflows through 69 layers
    calibrate_bn(init, init.to_device_batch(images(rng, 32)))
    path = os.path.join(workdir, "inception_bn_224.model.npz")
    init.save_model(path)
    del init
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    rec = Recorder()
    sess = ServeSession(cfg, model_path=path, device="cuda", monitor=rec)
    open_s = time.perf_counter() - t0
    eng = sess.engine
    pool = images(rng, 2 * MAX_BATCH)
    try:
        # the main path: counts to 0, drive, read
        kernels.reset_launch_counts()
        base = eng.counters_snapshot()
        rec.records.clear()
        t_drive = time.monotonic()
        loop = run_closed_loop(sess, pool, clients=8, requests=32,
                               request_rows=4)
        burst_rows = pool[:MAX_BATCH]
        t1 = time.perf_counter()
        futs = [sess.submit(burst_rows[i:i + 32])
                for i in range(0, MAX_BATCH, 32)]
        burst = np.concatenate([f.result(timeout=300) for f in futs])
        burst_s = time.perf_counter() - t1
        tails = tail_report(rec.records, t_drive)
        launches = kernels.conv_epilogue.launches
        snap = eng.counters_snapshot()
        dispatches = snap["dispatches"] - base["dispatches"]
        first4 = sess.predict(pool[:4])
    finally:
        summary = sess.close()
    failed = loop["error"] + loop["busy"] + loop["timeout"] \
        + summary["errors"] + summary["timeouts"] + summary["rejected"]
    finite = bool(np.all(np.isfinite(burst)) and np.all(np.isfinite(first4)))
    row_sums = np.concatenate([burst.sum(1), first4.sum(1)])
    sums_ok = bool(np.all(np.abs(row_sums - 1.0) < 1e-4))
    per_forward = len(eng.trainer.net.fold_pairs)
    counted = dispatches > 0 and launches == per_forward * dispatches

    # bucket-128 forward on the device (resident batch, CUDA events),
    # and the same through engine.run (staging + copies + fetch)
    t = eng.trainer
    dev_batch = t.to_device_batch(pool[:MAX_BATCH])
    launches_before = kernels.conv_epilogue.launches
    fwd_ms = cuda_time_ms(lambda i: t.pred(dev_batch, eng.nodes), 10)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        eng.run(pool[:MAX_BATCH])
    run_ms = (time.perf_counter() - t1) / 5 * 1e3
    # forward wall time per bucket (host clock around a synchronized
    # forward of a resident batch): where the host, not the device,
    # sets the floor
    fwd_by_bucket = {}
    for b in eng.buckets:
        xb = t.to_device_batch(pool[:b])
        t.pred(xb, eng.nodes)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            t.pred(xb, eng.nodes)
        torch.cuda.synchronize()
        fwd_by_bucket[b] = (time.perf_counter() - t1) / 5 * 1e3

    prof = profile_forward(t, dev_batch, eng.nodes)
    kernels.conv_epilogue.launches = launches_before

    # the same snapshot through the port on the CPU: the served rows and
    # the pooled features under them
    from cxxnet_tpu_torch.io import DataBatch
    cpu = NetTrainer(cfg, device="cpu")
    cpu.load_model(path)
    ref4 = cpu.extract_feature(DataBatch(pool[:4]), "top")
    gap_cpu = cpu.extract_feature(DataBatch(pool[:4]), "gap")
    gap_gpu = t.extract_feature(DataBatch(pool[:4]), "gap")
    kernels.conv_epilogue.launches = launches_before
    cpu_err = float(np.abs(first4 - ref4).max())
    gap_err = float(np.abs(gap_gpu - gap_cpu).max())
    close = bool(np.allclose(first4, ref4, rtol=SERVE_RTOL,
                             atol=SERVE_ATOL)
                 and np.allclose(gap_gpu, gap_cpu, rtol=SERVE_RTOL,
                                 atol=SERVE_ATOL))
    same_class = bool(np.array_equal(first4.argmax(1), ref4.argmax(1)))

    flops = t.net.analytic_flops_per_example()
    res = {"phase": "serve", "model": "inception_bn_224",
           "buckets": BUCKETS, "setup_s": setup_s, "open_s": open_s,
           "closed_loop": loop, "burst_rows": int(burst.shape[0]),
           "burst_s": burst_s, "summary": summary, "tails": tails,
           "failed_requests": failed, "dispatches": dispatches,
           "conv_epilogue_launches": launches,
           "launches_per_dispatch": launches / max(1, dispatches),
           "epilogues_per_forward": per_forward,
           "rows_per_sec": loop["rows_per_sec"],
           "p50_ms": summary["latency_p50_ms"],
           "p99_ms": summary["latency_p99_ms"],
           "fwd128_ms": fwd_ms, "img_per_s": MAX_BATCH / fwd_ms * 1e3,
           "fwd_tflops": flops * MAX_BATCH / (fwd_ms * 1e-3) / 1e12,
           "run128_ms": run_ms, "fwd_wall_ms_by_bucket": fwd_by_bucket,
           "profile": prof,
           "cpu_max_abs_err": cpu_err, "cpu_gap_max_abs_err": gap_err,
           "gap_max_abs": float(np.abs(gap_cpu).max()),
           "classes_of_4": first4.argmax(1).tolist(),
           "max_prob_of_4": first4.max(1).tolist(),
           "cpu_rtol": SERVE_RTOL,
           "cpu_atol": SERVE_ATOL, "cpu_close": close,
           "cpu_same_argmax": same_class, "finite": finite,
           "row_sums_ok": sums_ok,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["ok"] = bool(failed == 0 and finite and sums_ok and counted
                     and close)
    emit(res)
    if not res["ok"]:
        raise RuntimeError("serve phase failed")
    return res


# ------------------------------------------------------------- phase 4

# kernel-name substrings -> the kind of work a training step spends on
_KINDS = (("host-to-device copies", ("Memcpy HtoD",)),
          ("bn_apply kernels", ("cxn_bn_",)),
          ("matmul kernel", ("cxn_sgemm",)),
          ("relu_max_pool kernels", ("cxn_relu_max_pool",)),
          ("layout transposes", ("nhwcToNchw", "nchwToNhwc")),
          ("reductions (BN moments, BN gradient sums, loss)",
           ("reduce_kernel", "Reduce")),
          ("convolutions", ("conv", "gemm", "Gemm", "fft", "FFT", "xmma",
                            "complex",
                            "winograd", "Winograd", "implicit", "cudnn",
                            "cutlass", "sm90", "sm80", "dgrad", "wgrad")),
          ("pooling", ("pool",)),
          ("concat copies", ("Cat", "cat_")),
          ("elementwise (autograd BN gradient, optimizer, relu)",
           ("elementwise", "vectorized", "foreach", "Elementwise")))


def kind_of(name: str) -> str:
    for kind, keys in _KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


# per-step device time of the port's kernels, by kernel-name substring
BN_DEVICE_KEYS = {"bn_fwd_device_ms": "cxn_bn_fwd",
                  "bn_bwd_device_ms": "cxn_bn_bwd",
                  "matmul_device_ms": "cxn_sgemm"}
RMP_DEVICE_KEYS = {"relu_pool_fwd_device_ms": "cxn_relu_max_pool_fwd",
                   "relu_pool_bwd_device_ms": "cxn_relu_max_pool_bwd"}


def profile_step(t, batch, reps: int = 5, device_keys=BN_DEVICE_KEYS):
    """torch.profiler over ``reps`` training steps, one profile per
    step: device time by kernel name and by kind, the device's busy
    and idle share of the step, and the device time of the kernels
    named in ``device_keys``. The per-step figures are medians over
    the steps, each with its (min, max) under ``spread``; names and
    kinds are averaged over the steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls, names = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            t.update(batch)
            b.record()
            torch.cuda.synchronize()
        walls.append(a.elapsed_time(b))
        by_name = {}
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            e = by_name.setdefault(evt.name, [0.0, 0])
            e[0] += evt.time_range.elapsed_us() / 1e3
            e[1] += 1
        names.append(by_name)

    def dev_ms(by_name, key):
        return sum(v[0] for k, v in by_name.items() if key in k)
    per_step = {"wall_ms": walls,
                "device_busy_ms": [dev_ms(n, "") for n in names]}
    for key, sub in device_keys.items():
        per_step[key] = [dev_ms(n, sub) for n in names]
    per_step["idle_share"] = [1.0 - busy / wall for busy, wall in
                              zip(per_step["device_busy_ms"], walls)]
    mean = {}
    for by_name in names:
        for name, (ms, cnt) in by_name.items():
            e = mean.setdefault(name, [0.0, 0.0])
            e[0] += ms / reps
            e[1] += cnt / reps
    kinds = {}
    for name, (ms, cnt) in mean.items():
        k = kinds.setdefault(kind_of(name), [0.0, 0.0])
        k[0] += ms
        k[1] += cnt
    top = sorted(mean.items(), key=lambda kv: -kv[1][0])[:20]
    out = {k: float(np.median(v)) for k, v in per_step.items()}
    out.update({
        "reps": reps,
        "spread": {k: [min(v), max(v)] for k, v in per_step.items()},
        "kernels_per_step": sum(v[1] for v in mean.values()),
        "by_kind": {k: {"ms": v[0], "n": v[1]} for k, v in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": k[:90], "ms": v[0], "n": v[1]} for k, v in top]})
    return out


def _as_float64(t) -> None:
    """Cast a trainer's weights, BN statistics and optimizer state to
    float64 in place (the precision witness of ``update_delta_check``;
    the plain path only: the kernels take float32)."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.double()
                for k, v in tree.items()}
    t.params, t.net_state, t.opt_state = \
        cast(t.params), cast(t.net_state), cast(t.opt_state)


def seeded_uniform(shape, key, device):
    """Dropout draws that are the same on every device: numpy's, from
    the key's generator seed (``layers.common.dropout_uniform``'s
    stand-in for the batch-4 update check)."""
    import torch
    rs = np.random.RandomState(key.generator_seed() % (2 ** 32))
    return torch.from_numpy(
        rs.random_sample(tuple(shape)).astype(np.float32)).to(device)


def inception_plain_cfg(cfg):
    """The Inception-BN training config through the plain versions:
    BN without the kernel, fc1 as ``fullc`` (the same function, the
    same seeded weights)."""
    return [(n, v.replace("pallas_fullc:", "fullc:"))
            for n, v in cfg if n != "bn_pallas"] + [("bn_pallas", "0")]


def update_delta_check(workdir: str, cfg=None, plain_cfg=None,
                       same_masks: bool = False, tag: str = "train4"):
    """One update at batch 4 from the same seeded weights and batch,
    compared per parameter as ||d_a - d_b|| / ||d_b|| with d = w_after -
    w_before. Runs: the card through the kernels (``gpu``) and through
    the plain versions (``plain_cfg``; for Inception-BN ``bn_pallas =
    0`` and fc1 as ``fullc``: ``gpu_plain``); the CPU (``cpu``); the
    plain path in float64 on the card and on the CPU (``gpu_f64``,
    ``cpu_f64``); and, to place the card's float32 error, the kernels
    with cuDNN switched off, so the convolutions run as im2col and
    cuBLAS products (``gpu_no_cudnn``). With ``same_masks`` every run
    draws its dropout masks from :func:`seeded_uniform`, so the card
    and the CPU drop the same units.

    At this state the float32 update of the deep layers is
    ill-conditioned: a change of summation order alone moves it by
    about 0.6 % (PERF.md section 6), so no float32 run can be held to
    another within 1e-3. float64 shrinks that by about nine decimal
    digits and leaves a card-side fault (convolution or pooling
    backward, autograd through the moments, the optimizer) as large as
    it was. Held, each within UPDATE_RTOL for every parameter: the
    card's float64 update against the CPU's, and the card's kernels
    against its plain path (which isolates the kernels); and the float32
    losses against the CPU's within LOSS_RTOL. The float32 runs against
    ``cpu_f64`` are reported, not held."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import common
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    if cfg is None:
        cfg = train_cfg(4)
        plain_cfg = inception_plain_cfg(cfg)
    paths = {}
    for name, c in (("kernels", cfg), ("plain", plain_cfg)):
        init = NetTrainer(c, device=DEVICE)
        init.init_model()
        paths[name] = os.path.join(workdir, "%s_%s.model.npz" % (tag, name))
        init.save_model(paths[name])
        del init
    rng = np.random.RandomState(SEED + 4)
    batch = DataBatch(images(rng, 4),
                      rng.randint(0, NCLASS, (4, 1)).astype(np.float32))

    def delta(dev, plain=False, f64=False, cudnn=True):
        t = NetTrainer(plain_cfg if plain else cfg, device=dev)
        t.load_model(paths["plain" if plain else "kernels"])
        if f64:
            _as_float64(t)
        w0 = {(lk, tag): w.detach().cpu().clone()
              for lk, sub in t.params.items() for tag, w in sub.items()}
        before = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn
        try:
            if f64:
                # update() ships the batch as float32; the same step on a
                # float64 copy of it
                data, labels, mask = t._device_batch(batch)
                t._last_loss, _ = t._train_step(
                    data.double(), labels, mask, t.update_counter, True,
                    False, t._step_scalar())
            else:
                t.update(batch)
        finally:
            torch.backends.cudnn.enabled = before
        return ({k: t.params[k[0]][k[1]].detach().cpu().double() - w0[k]
                 for k in w0}, t.last_loss)

    uniform = common.dropout_uniform
    if same_masks:
        common.dropout_uniform = seeded_uniform
    try:
        runs = {"gpu": delta(DEVICE), "gpu_plain": delta(DEVICE, plain=True),
                "cpu": delta("cpu"),
                "gpu_f64": delta(DEVICE, plain=True, f64=True),
                "cpu_f64": delta("cpu", plain=True, f64=True),
                "gpu_no_cudnn": delta(DEVICE, cudnn=False)}
    finally:
        common.dropout_uniform = uniform

    def rel(a, b, k):
        nb = float(runs[b][0][k].norm())
        return float((runs[a][0][k] - runs[b][0][k]).norm()) / max(nb, 1e-30)

    def whole(a, b):
        num = sum(float((runs[a][0][k] - runs[b][0][k]).norm()) ** 2
                  for k in runs[b][0])
        den = sum(float(v.norm()) ** 2 for v in runs[b][0].values())
        return (num / max(den, 1e-60)) ** 0.5

    # (run, reference): the held pairs first, then the reported ones
    held = (("gpu_f64", "cpu_f64"), ("gpu", "gpu_plain"))
    pairs = held + (("gpu", "cpu"), ("cpu", "cpu_f64"), ("gpu", "cpu_f64"),
                    ("gpu_no_cudnn", "cpu_f64"))
    keys = list(runs["cpu"][0])
    table = {"%s_vs_%s" % p: [rel(p[0], p[1], k) for k in keys]
             for p in pairs}
    failed = sorted({"%s/%s" % keys[i] for a, b in held
                     for i, r in enumerate(table["%s_vs_%s" % (a, b)])
                     if not r <= UPDATE_RTOL})
    loss = {k: v[1] for k, v in runs.items()}
    loss_ok = all(abs(loss[k] - loss["cpu"]) <= LOSS_RTOL * abs(loss["cpu"])
                  for k in loss)
    out = {"params": len(keys), "losses": loss, "loss_ok": loss_ok,
           "rtol": UPDATE_RTOL, "held": ["%s_vs_%s" % p for p in held],
           "whole": {"%s_vs_%s" % p: whole(*p) for p in pairs},
           "worst": {name: max(v) for name, v in table.items()},
           "failed": failed,
           # [param, then one column per pair in the order of "whole"]
           "rows": [["%s/%s" % k] + [table[n][i] for n in table]
                    for i, k in enumerate(keys)]}
    out["ok"] = bool(loss_ok and not failed)
    return out


def pool_backward_check(net, batch: int = 8):
    """Every pool of the training path, forward and backward through the
    port's PoolingLayer on the card and on the CPU, on relu'd inputs
    rounded to steps of 0.5 so that max windows hold tied maxima, zeros
    and positive values alike. Max: the gradient entries that differ,
    i.e. where the card credits a tie to another element than the CPU
    does; none may. Avg: the largest gradient difference, within
    SUM_RTOL of the largest entry (the same nine terms, summed in
    another order). For a padded avg pool it also reports, not held,
    how far the card's backward of ``F.avg_pool2d`` with the pad inside
    the op (which the port avoids) lies from the CPU's, relative to its
    norm: ``in_op_pad_grad_rel_err``."""
    import torch.nn.functional as F
    import torch
    out = []
    for li, info in enumerate(net.graph.layers):
        if info.type not in ("max_pooling", "avg_pooling"):
            continue
        layer = net.layer_objs[li]
        s = layer.in_shapes[0]
        gen = torch.Generator().manual_seed(SEED + li)
        x = torch.relu(torch.round(2 * torch.randn(
            (batch, s.y, s.x, s.ch), generator=gen)) / 2)
        grads = {}
        for dev in ("cpu", DEVICE):
            xd = x.to(dev).requires_grad_(True)
            (y,), _ = layer.forward({}, {}, [xd], True)
            dy = torch.arange(y.numel(), dtype=torch.float32,
                              device=dev).reshape(y.shape) % 7 + 1
            (g,) = torch.autograd.grad(y, [xd], dy)
            grads[dev] = (y.detach().cpu(), g.cpu())
            if info.type == "avg_pooling" and layer.param.pad_y:
                p = layer.param
                yi = F.avg_pool2d(xd.permute(0, 3, 1, 2), p.kernel_height,
                                  p.stride, padding=p.pad_y,
                                  count_include_pad=True)
                (gi,) = torch.autograd.grad(yi, [xd],
                                            dy.permute(0, 3, 1, 2))
                grads[dev + "_in_op"] = gi.cpu()
        (yc, gc), (yg, gg) = grads["cpu"], grads[DEVICE]
        r = {"layer": net.graph.layers[li].name or "layer%d" % li,
             "type": info.type, "in_shape": [batch, s.y, s.x, s.ch],
             "kernel": layer.param.kernel_height,
             "stride": layer.param.stride, "pad": layer.param.pad_y,
             "fwd_max_abs_err": float((yc - yg).abs().max()),
             "grad_max_abs_err": float((gc - gg).abs().max()),
             "grad_entries_differing": int((gc != gg).sum()),
             "grad_entries": int(gc.numel())}
        if "cpu_in_op" in grads:
            ref = grads["cpu_in_op"]
            r["in_op_pad_grad_rel_err"] = float(
                (grads[DEVICE + "_in_op"] - ref).norm() / ref.norm())
        if info.type == "max_pooling":
            r["ok"] = r["fwd_max_abs_err"] == 0 \
                and r["grad_entries_differing"] == 0
        else:
            scale = float(gc.abs().max())
            r["ok"] = r["fwd_max_abs_err"] <= SUM_RTOL * float(
                yc.abs().max()) and r["grad_max_abs_err"] <= SUM_RTOL * scale
        out.append(r)
    return out


def drive_train(cfg, expected, device_keys):
    """The training main path at batch TRAIN_BATCH: a seeded trainer
    from ``cfg``, 2 warm and 10 timed ``update`` steps on one batch
    (CUDA events and host clock), every step's launches against
    ``expected`` (counts set to 0 just before, read just after), the
    losses, peak memory and a profiled step. Returns (trainer, result)."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    t0 = time.perf_counter()
    t = NetTrainer(cfg, device=DEVICE)
    t.init_model()
    rng = np.random.RandomState(SEED + 1)
    batch = DataBatch(images(rng, TRAIN_BATCH),
                      rng.randint(0, NCLASS, (TRAIN_BATCH, 1))
                      .astype(np.float32))
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, per_step = [], []
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)

    def step():
        before = kernels.launch_counts()
        t.update(batch)
        losses.append(t._last_loss)
        after = kernels.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})

    # the main path: counts to 0, drive, read
    kernels.reset_launch_counts()
    t_first = time.perf_counter()
    for _ in range(WARM_STEPS):
        step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_first
    t1 = time.perf_counter()
    a.record()
    for _ in range(TIMED_STEPS):
        step()
    b.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) / TIMED_STEPS * 1e3
    launches = kernels.launch_counts()
    strided_dy = kernels.relu_max_pool_bwd.strided_dy
    step_ms = a.elapsed_time(b) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    loss_values = [float(v) for v in losses]

    prof = profile_step(t, batch, device_keys=device_keys)
    flops = t.net.analytic_flops_per_example()
    steps = WARM_STEPS + TIMED_STEPS
    counted = all(ps == expected for ps in per_step) and all(
        launches[k] == n * steps for k, n in expected.items())
    finite = bool(np.all(np.isfinite(loss_values)))
    falling = finite and loss_values[-1] < loss_values[0]
    res = {"batch": TRAIN_BATCH, "setup_s": setup_s,
           "first_steps_s": warm_s, "warm_steps": WARM_STEPS,
           "timed_steps": TIMED_STEPS, "step_ms": step_ms,
           "step_wall_ms": wall_ms,
           "img_per_s": TRAIN_BATCH / step_ms * 1e3,
           "tflops": 3 * flops * TRAIN_BATCH / (step_ms * 1e-3) / 1e12,
           "fwd_gflop_per_img": flops / 1e9,
           "peak_mem_gb": peak / 1e9, "losses": loss_values,
           "finite": finite, "loss_falls": falling,
           "launches": launches, "launches_per_step": per_step[-1],
           "expected_per_step": expected, "counted": counted,
           "relu_pool_bwd_strided_dy": strided_dy, "profile": prof}
    return t, res


def phase_train(workdir: str):
    t, res = drive_train(train_cfg(TRAIN_BATCH), TRAIN_LAUNCHES,
                         BN_DEVICE_KEYS)
    delta = update_delta_check(workdir)
    pools = pool_backward_check(t.net)
    res = dict({"phase": "train", "model": "inception_bn_224",
                "config": "pallas_fullc fc1, bn_pallas, bn_fuse_relu, f32, "
                          "TF32 off, sgd momentum 0.9"}, **res)
    res.update(update_vs_cpu=delta, pool_backward_vs_cpu=pools)
    res["ok"] = bool(res["counted"] and res["loss_falls"] and delta["ok"]
                     and all(p["ok"] for p in pools))
    emit(res)
    if not res["ok"]:
        raise RuntimeError("train phase failed")
    return res


# ------------------------------------------------------------- phase 5


def phase_train_kaiming(workdir: str):
    t, res = drive_train(kaiming_cfg(TRAIN_BATCH), KAIMING_LAUNCHES,
                         RMP_DEVICE_KEYS)
    delta = update_delta_check(workdir, kaiming_cfg(4), kaiming_cfg(4, 0),
                               same_masks=True, tag="kaiming4")
    pools = pool_backward_check(t.net)
    res = dict({"phase": "train_kaiming", "model": "kaiming_224",
                "config": "fused_pools, pallas_pool = 1, dropout 0.5, "
                          "f32, TF32 off, sgd momentum 0.9"}, **res)
    res.update(update_vs_cpu=delta, pool_backward_vs_cpu=pools)
    res["ok"] = bool(res["counted"] and res["loss_falls"] and delta["ok"]
                     and all(p["ok"] for p in pools))
    emit(res)
    if not res["ok"]:
        raise RuntimeError("train_kaiming phase failed")
    return res


def kernels_line(kres, sres, tres, kmres, part: str):
    """The ``kernels`` record: every ported kernel with its launches on
    its path's run, its error against its plain version, its times on
    the card and its bound, at the path's shapes."""
    fwd = kres["forward_sum"]
    bn, mm, rmp = kres["bn_apply"], kres["matmul"], kres["relu_max_pool"]
    prof, kprof = tres["profile"], kmres["profile"]
    per_step = "one training step at batch %d" % TRAIN_BATCH
    per_kstep = "one kaiming-224 training step at batch %d: %d launches" \
        % (TRAIN_BATCH, rmp["launches_per_step"])
    return {"kernels": [
        dict(EPILOGUE, launches=sres["conv_epilogue_launches"],
             max_abs_err=kres["max_abs_err"], ms=fwd["ms"],
             plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
             bound_by=kres["bound_by"], library_ms=None,
             device_ms=sres["profile"]["epilogue_device_ms"],
             per="one forward at bucket 128: %d launches"
             % kres["path_launches_per_forward"], peaks=part),
        dict(BN_FWD, launches=tres["launches"]["bn_apply_fwd"],
             max_abs_err=bn["fwd_max_abs_err"], ms=bn["step_sum"]["fwd_ms"],
             plain_ms=bn["step_sum"]["fwd_plain_ms"],
             bound_ms=bn["step_sum"]["fwd_bound_ms"],
             bound_by=bn["fwd_bound_by"], library_ms=None,
             device_ms=prof["bn_fwd_device_ms"],
             per="%s: %d launches" % (per_step, bn["launches_per_step"]),
             peaks=part),
        dict(BN_BWD, launches=tres["launches"]["bn_apply_bwd"],
             max_abs_err=bn["bwd_max_abs_err"], ms=bn["step_sum"]["bwd_ms"],
             plain_ms=bn["step_sum"]["bwd_plain_ms"],
             bound_ms=bn["step_sum"]["bwd_bound_ms"],
             bound_by=bn["bwd_bound_by"], library_ms=None,
             device_ms=prof["bn_bwd_device_ms"],
             sum_max_rel_err=bn["bwd_sum_max_rel"],
             per="%s: %d launches" % (per_step, bn["launches_per_step"]),
             peaks=part),
        dict(MATMUL, launches=tres["launches"]["matmul"],
             max_abs_err=mm["max_abs_err"], ms=mm["step_sum"]["ms"],
             plain_ms=mm["step_sum"]["plain_ms"],
             bound_ms=mm["step_sum"]["bound_ms"], bound_by=mm["bound_by"],
             library_ms=mm["step_sum"]["library_ms"],
             device_ms=prof["matmul_device_ms"],
             max_rel_err=mm["max_rel_err"],
             per="%s: %d launches" % (per_step, mm["launches_per_step"]),
             peaks=part),
        dict(RMP_FWD, launches=kmres["launches"]["relu_max_pool_fwd"],
             max_abs_err=rmp["fwd_max_abs_err"],
             ms=rmp["step_sum"]["fwd_ms"],
             plain_ms=rmp["step_sum"]["fwd_plain_ms"],
             bound_ms=rmp["step_sum"]["fwd_bound_ms"],
             bound_by=rmp["fwd_bound_by"], library_ms=None,
             reference_ms=rmp["step_sum"]["reference_fwd_ms"],
             reference=rmp["reference"],
             device_ms=kprof["relu_pool_fwd_device_ms"], per=per_kstep,
             peaks=part),
        dict(RMP_BWD, launches=kmres["launches"]["relu_max_pool_bwd"],
             max_abs_err=rmp["bwd_max_abs_err"],
             ms=rmp["step_sum"]["bwd_ms"],
             plain_ms=rmp["step_sum"]["bwd_plain_ms"],
             bound_ms=rmp["step_sum"]["bwd_bound_ms"],
             bound_by=rmp["bwd_bound_by"], library_ms=None,
             reference_ms=rmp["step_sum"]["reference_bwd_ms"],
             reference=rmp["reference"],
             device_ms=kprof["relu_pool_bwd_device_ms"], per=per_kstep,
             peaks=part)]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU "
              "only", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cxxnet_tpu_torch")):
        print("chip_smoke: cxxnet_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    phase = "env"
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        from cxxnet_tpu_torch.device import resolve_device
        resolve_device("cuda")           # TF32 off before any product
        smi = phase_env()
        bw, flops, part = card_peaks(torch.cuda.get_device_name(0))
        phase = "kernels"
        kres = phase_kernels(bw, flops)
        phase = "serve"
        sres = phase_serve(workdir)
        phase = "train"
        tres = phase_train(workdir)
        phase = "train_kaiming"
        kmres = phase_train_kaiming(workdir)
    except Exception as e:
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": "%s: %s" % (type(e).__name__, e)})
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit(kernels_line(kres, sres, tres, kmres, part))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
