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
             1e-5 of sum |a*b|), each with the route and split count
             its plan took (``kernels.matmul_plan``); ``relu_max_pool``
             forward and backward (both bit-exact, signs of zero and
             NaN positions included) at kaiming-224's three fused
             pools at batch 128 on inputs in steps of 0.5
             (tied maxima), with the cotangent also as a permuted view,
             each launch's route printed (``kernels.relu_max_pool_plan``;
             the path's pools must slide at 16-byte vectors), plus a
             ragged-channel (C = 3), a NaN, a ragged strip and column
             tile, a k = 2, a k = 5 (generic route), C = 72 and C = 68
             and a misaligned-x (scalar route) case;
             ``conv_epilogue`` on the int32 accumulator of an int8 conv
             (values in +-4e7, beyond 2^24) and bf16 -> bf16 at every
             served shape, int32 also with ragged C and a bf16 output,
             all bit-exact; its backward (row 5b, through the bn_apply
             backward kernel) at the stem shape. The bf16 instantiations
             of the training kernels (``train_bf16``): bn_apply at every
             batch-norm shape of the bench-set Inception-BN step
             (forward and dx the same bits, sums within rtol 1e-5),
             matmul at fc1's bf16 . bf16 (which must take the
             tensor cores, ``wgmma``), f32 . bf16 and bf16 . f32
             products (library: torch.mm with out_dtype=float32), a
             ragged bf16 . bf16 product on the tensor cores (77 x 1000
             x 136) and one whose 129-wide rows TMA cannot read (the FMA
             route), and
             relu_max_pool at kaiming-224's pools (the same bits). The
             pool_concat slice: ``pool_concat`` forward and the pool
             branch's backward at every fused concat of the Inception
             tower (phase 8) at batch 128, f32 and bf16, the same bits as
             the plain versions on inputs in steps of 0.5, from
             channels-last views of the branches and a permuted
             cotangent, plus ragged widths (k = 5), a NaN and an N(0, 9)
             avg case; conv_epilogue's bf16 VJP (``cxn_conv_epilogue_bwd``)
             at the stem shape for (x, y) = (bf16, bf16), (f32, bf16),
             (bf16, f32): dx the same bits, sums within rtol 1e-5; the
             bf16 bias gradient (``bias_grad_bf16``, XLA:CPU's summation
             order) at kaiming-224's 14 bias shapes and at AlexNet.conf's
             8 (batch 256), the same bits. Max
             error, kernel / plain / library times (CUDA events) and the
             bound from bytes and operations; for matmul, the bn_apply
             backward and forward and conv_epilogue's VJP also the
             kernel's (and the library call's) device time per call
             from the profiler (``device_ms``: back-to-back events
             around a ~10 us kernel time its Python wrapper), and for
             relu_max_pool too (summed over the path: the "kernel
             section"); for relu_max_pool, in place
             of a library call, F.relu + F.max_pool2d and their autograd
             backward (two calls, and a backward that credits one tie);
             for pool_concat F.pad + F.max_pool2d / F.avg_pool2d +
             torch.cat and their backward.
3. serve   — Inception-BN-224 (1000 classes, random weights from a seed,
             realistic BN running stats) saved as a snapshot, served
             through ``ServeSession(device="cuda")`` to closed-loop
             clients and one full-bucket burst; launch counts show the
             path went through the kernels; 4 rows are held against the
             port on the CPU.
4. serve_lowp — the same snapshot calibrated on 8 seeded batches of 128
             (``Calibrator``), gated (mean |int8 - f32| of the softmax
             rows within 0.05, top-1 agreement reported), written as an
             int8 snapshot and served at ``serve_dtype = int8`` through
             ``ServeSession(device="cuda")`` with the serve phase's
             drive: 0 failed requests, exactly 69 int32 conv_epilogue
             launches per forward and none of the other kernels, the
             bucket-128 forward beside the float32 one, peak memory, a
             profiled forward by kind, 4 rows against the CPU (atol
             1e-3, the same top-1 where the CPU's top two differ by more
             than the tolerance); then ``serve_dtype = bfloat16``: one
             bucket-128 forward with 69 bf16 conv_epilogue launches and
             4 rows against the CPU's.
5. train   — Inception-BN-224 with fc1 declared ``pallas_fullc`` and
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
6. train_bf16 — phase 5's net at the repo's own mixed precision (bench.py's
             ``dtype = grad_dtype = momentum_dtype = bfloat16``), batch
             128: 2 warm and 10 timed steps, exactly 69 + 69 bf16
             bn_apply and 3 bf16 matmul launches per step and no float32
             one, the loss finite and falling, a profiled step, the f32
             step time of phase 5 beside it; then one batch-4 update
             through the kernels against the card's bf16 plain path (the
             layers' kernel entry points swapped for Functions over the
             plain versions, cuDNN deterministic): the loss within rtol
             1e-5, the whole update within 5e-2 and within a tenth of
             the distance at which the cuDNN-off plain path lies from
             the plain path (``BF16_UPDATE_RTOL`` says why not bit for
             bit).
7. train_kaiming — kaiming-224 (model J', ``fused_pools``, ``pallas_pool =
             1``, dropout 0.5 on fc1 and fc2), seeded weights, batch 128:
             2 warm and 10 timed ``update`` steps as in phase 5; exactly 3
             relu_max_pool forward and 3 backward launches per step and
             none of the other kernels; the loss finite and falling; a
             profiled step; the batch-4 update check of phase 5 with the
             same dropout masks injected on the card and on the CPU (the
             plain path is ``pallas_pool = 0``: relu, then max pooling);
             and the SPP max pools' backward against the CPU's. Then the
             same at bench.py's kaiming set (``dtype = momentum_dtype =
             bfloat16``): exactly 3 + 3 bf16 relu_max_pool launches per
             step and 14 bf16 bias gradients (``bias_grad_bf16``), the
             loss falling, and phase 6's batch-4 check with the same
             masks.
8. tower   — the pool_concat slice: an Inception tower (Inception-BN-224's
             stem, then t3a / t3b / t3c / t4a at Inception-BN's widths
             without the pool projections, global avg pool, fc1, 1000
             classes) with ``pool_concat_pallas = 1``. Trained at batch
             128 as phase 5 (exactly 26 + 26 bn_apply, 3 matmul and 2 + 2
             pool_concat launches per step, t3a's avg and t4a's max
             concat fused; the float64 batch-4 update check, its plain
             runs through pool_concat's plain version) and at the bench
             set as phase 6 (26 + 26 bf16 bn_apply, 3 bf16 matmul and 3 + 3
             bf16 pool_concat, the gate admitting t3b's concat at bf16;
             the batch-4 check against the card's bf16 plain path); then
             served at f32 from a snapshot through
             ``ServeSession(device="cuda")`` with phase 3's drive: 0
             failed requests, exactly 26 conv_epilogue and 2 pool_concat
             launches per forward, 4 rows against the CPU.
9. cli     — the CLI slice through its entry point, ``python -m
             cxxnet_tpu_torch.main``: ``example/MNIST/MNIST.conf`` as a
             subprocess from a directory whose data/ links the tracked
             idx files (24,000 / 2,000 digits), 15 rounds, best
             test-error below 0.03, its wall time and each round's
             training rows/s (the gap between two round lines, the test
             pass included); then ``example/ImageNet/Inception-BN.conf``
             in process (``LearnTask().run``), only its data paths
             pointed at seeded raw-tensor imgrec archives (300 train and
             200 val records of 256x256x3 uint8, labels in 0-999): 2
             rounds at the conf's batch 128, 224 crop, 1000 classes and
             ``dtype = bfloat16`` with ``bn_pallas = bn_fuse_relu = 1``
             (the round lines, every update's loss finite, 0002.model.npz
             written, exactly 69 + 69 bf16 bn_apply and 1 bias_grad_bf16
             launches per update and none in the round lines' eval
             forwards, each update's time and each round's rows/s);
             ``pred``, ``pred_raw`` and ``extract`` (the pooled features,
             node ``flat``) over val.rec from that snapshot (a pred block
             given on the command line) with ``bn_fold_eval =
             bn_fuse_relu = conv_pallas_epilogue = 1``: 200 classes in
             0-999, 200 rows summing to 1, 69 bf16 conv_epilogue
             launches per forward, the first 4 rows and their pooled
             features against the port on the CPU (bf16 tolerances: the
             eval path runs in the conf's bf16); ``serve`` with 8 clients x 8
             requests x 4 rows, 0 failed, 69 per forward; and the MNIST
             snapshot quantized (``task = quantize``, the 0.05 gate) and
             served at ``serve_dtype = int8``, 0 failed.

10. alexnet — the layer-zoo slice: ``example/ImageNet/AlexNet.conf`` in
             process through the CLI (``LearnTask().run``), only its data
             paths, ``num_round`` and ``model_dir`` set from outside, on
             seeded raw-tensor imgrec archives (512 train and 256 val
             records of 256x256x3 uint8, labels in 0-999): 2 rounds at
             the conf's batch 256, 227 crop, 1000 classes, grouped convs,
             two LRNs and ``dtype = bfloat16`` (the round lines, every
             update's loss finite, 0002.model.npz written, exactly 8
             bias_grad_bf16 launches per update and no other, none in the
             round lines' eval forwards, each update's time and each
             round's rows/s with its ``data_wait_s``); one profiled step
             of the conf's net (device time by kind) and each LRN's
             forward + backward device time at its shape; ``pred``,
             ``pred_raw`` and ``extract`` (fc7's features) over val.rec
             from the snapshot: 256 classes in 0-999, the first 4 rows
             and features against the port on the CPU (the cli phase's
             bf16 tolerances); one batch-4 bf16 update through the kernel
             against the card's plain path (``bf16_update_check``, the
             same dropout masks); and the zoo net (``zoo_text``: every
             layer type of the slice, batch 8, 32 px): one float32 update
             on the card against the CPU port per parameter
             (``update_delta_check``, the stochastic layers' draws from
             ``seeded_uniform`` on both), and the pairtest's max_diff.

Then a ``kernels`` line (every ported kernel with its launches, error
and times; ``cli_launches`` and ``alexnet_launches``: its count over
the cli phase's runs and the alexnet phase's training run; the
bias_grad_bf16 row also with AlexNet's per-update sums), the
``nvidia-smi`` line, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
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
EPILOGUE_INT32 = dict(EPILOGUE, name="conv_epilogue_int32")
EPILOGUE_BF16 = dict(EPILOGUE, name="conv_epilogue_bf16")
EPILOGUE_BWD = {"name": "conv_epilogue_bwd", "route": "cuda",
                "source": "cxxnet_tpu_torch/csrc/bn_apply.cu",
                "replaces": "cxxnet_tpu/layers/pallas_kernels.py:388"}
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
# the bf16 instantiations of the training kernels (dtype = bfloat16)
BN_FWD_BF16 = dict(BN_FWD, name="bn_apply_fwd_bf16")
BN_BWD_BF16 = dict(BN_BWD, name="bn_apply_bwd_bf16")
MATMUL_BF16 = dict(MATMUL, name="matmul_bf16")
RMP_FWD_BF16 = dict(RMP_FWD, name="relu_max_pool_fwd_bf16")
RMP_BWD_BF16 = dict(RMP_BWD, name="relu_max_pool_bwd_bf16")
# the last two TPU kernels: pool_concat (forward, and its VJP, XLA code
# in the reference), and conv_epilogue's VJP on bf16; and the bias
# gradient under dtype = bfloat16 (XLA's bf16 reduce in the reference)
PC_FWD = {"name": "pool_concat_fwd", "route": "cuda",
          "source": "cxxnet_tpu_torch/csrc/pool_concat.cu",
          "replaces": "cxxnet_tpu/layers/pallas_kernels.py:412"}
PC_BWD = {"name": "pool_concat_bwd", "route": "cuda",
          "source": "cxxnet_tpu_torch/csrc/pool_concat.cu",
          "replaces": "cxxnet_tpu/layers/pallas_kernels.py:494"}
PC_FWD_BF16 = dict(PC_FWD, name="pool_concat_fwd_bf16")
PC_BWD_BF16 = dict(PC_BWD, name="pool_concat_bwd_bf16")
EPILOGUE_BWD_BF16 = dict(EPILOGUE_BWD, name="conv_epilogue_bwd_bf16")
BIAS_BF16 = {"name": "bias_grad_bf16", "route": "cuda",
             "source": "cxxnet_tpu_torch/csrc/bias_grad_bf16.cu",
             "replaces": "cxxnet_tpu/layers/conv.py:258"}
NCLASS = 1000
DEVICE = "cuda"
TRAIN_BATCH = 128
TRAIN_KNOBS = [("bn_pallas", "1"), ("bn_fuse_relu", "1")]
# the repo's mixed-precision training set (bench.py, Inception-BN.conf)
BENCH_BF16 = [("dtype", "bfloat16"), ("grad_dtype", "bfloat16"),
              ("momentum_dtype", "bfloat16")]
WARM_STEPS, TIMED_STEPS = 2, 10
# every launch counter (layers/kernels.py launch_counts()); bn_apply,
# matmul and relu_max_pool count float32 and bf16 launches apart
NO_LAUNCHES = {k: 0 for k in (
    "conv_epilogue", "conv_epilogue_int32", "conv_epilogue_bf16",
    "conv_epilogue_bwd", "conv_epilogue_bwd_bf16", "bn_apply_fwd",
    "bn_apply_fwd_bf16", "bn_apply_bwd", "bn_apply_bwd_bf16", "matmul",
    "matmul_bf16", "relu_max_pool_fwd", "relu_max_pool_fwd_bf16",
    "relu_max_pool_bwd", "relu_max_pool_bwd_bf16", "pool_concat_fwd",
    "pool_concat_fwd_bf16", "pool_concat_bwd", "pool_concat_bwd_bf16",
    "bias_grad_bf16")}
# per training step of Inception-BN-224: launches each wrapper must
# count, in float32 and at the bench set
TRAIN_LAUNCHES = dict(NO_LAUNCHES, bn_apply_fwd=69, bn_apply_bwd=69,
                      matmul=3)
TRAIN_BF16_LAUNCHES = dict(NO_LAUNCHES, bn_apply_fwd_bf16=69,
                           bn_apply_bwd_bf16=69, matmul_bf16=3)
# per training step of kaiming-224 with fused_pools and pallas_pool = 1
KAIMING_LAUNCHES = dict(NO_LAUNCHES, relu_max_pool_fwd=3,
                        relu_max_pool_bwd=3)
# (at dtype = bfloat16 every conv and fullc bias of kaiming's 11 convs
# and 3 fullc layers sums its gradient in bf16)
KAIMING_BF16_LAUNCHES = dict(NO_LAUNCHES, relu_max_pool_fwd_bf16=3,
                             relu_max_pool_bwd_bf16=3, bias_grad_bf16=14)
# per training step of the Inception tower (phase 8): 26 batch norms, fc1
# as pallas_fullc, the fused concats (2 at f32, 3 at the bench set)
TOWER_LAUNCHES = dict(NO_LAUNCHES, bn_apply_fwd=26, bn_apply_bwd=26,
                      matmul=3, pool_concat_fwd=2, pool_concat_bwd=2)
TOWER_BF16_LAUNCHES = dict(NO_LAUNCHES, bn_apply_fwd_bf16=26,
                           bn_apply_bwd_bf16=26, matmul_bf16=3,
                           pool_concat_fwd_bf16=3, pool_concat_bwd_bf16=3)
# per served forward of the tower: every folded conv, the fused concats
TOWER_SERVE_LAUNCHES = dict(NO_LAUNCHES, conv_epilogue=26, pool_concat_fwd=2)
# per bucket forward of the float32-served Inception-BN-224 (every
# folded conv's output through conv_epilogue), of the int8-served one
# (every conv's int32 accumulator) and of the bf16-served one
SERVE_LAUNCHES = dict(NO_LAUNCHES, conv_epilogue=69)
INT8_LAUNCHES = dict(NO_LAUNCHES, conv_epilogue=69, conv_epilogue_int32=69)
BF16_LAUNCHES = dict(NO_LAUNCHES, conv_epilogue=69, conv_epilogue_bf16=69)
# quantization: calibration batches and the parity gate of the
# reference's task = quantize (mean |int8 - f32| of the softmax rows)
CALIB_BATCHES = 8
GATE_EPS = 0.05
# the card's int8 rows against the port on the CPU: the int8 weights
# are the same (checked), the int8 products exact and the epilogue
# bit-exact on both, so only the float32 avg pools, fc and softmax sum
# in another order (7.45e-9 seen on the H100)
INT8_CPU_ATOL = 1e-6
# the card's bf16 rows against the CPU's. Every conv output is rounded
# to bf16 (2^-9 relative), and cuDNN and oneDNN sum a bf16 convolution
# in different orders, so now and then the two round a sum to
# neighbouring bf16 values; such a step carries through up to 69 convs
# to the bf16 logits, whose ulp is 2^-5 for |z| in [4, 8). A logit
# moved by k ulps moves a softmax entry p by about k * 2^-5 * p, so
# three ulps give ~0.1 p (the relative error measured is reported
# beside it as max_rel_err)
BF16_CPU_RTOL, BF16_CPU_ATOL = 0.1, 1e-6
SERVE_SNAPSHOT = "inception_bn_224.model.npz"
# channel sums and matmul outputs: error against rtol * sum |terms|
SUM_RTOL = 1e-5
# one update at batch 4, per parameter: the card's float64 update
# against the CPU's, and the kernels against the card's plain path
UPDATE_RTOL = 1e-3
LOSS_RTOL = 1e-5
# the bench-set update at batch 4, kernels against the card's bf16
# plain path (the same ops, cuDNN deterministic): the channel sums of
# bn_apply's backward and the matmul's sums run in another order than
# torch.sum's and cuBLAS's, which moves an f32 gradient by an ulp, and
# a bf16 cast (the matmul's dx, every bf16 weight's gradient) turns that
# now and then into a 2^-8 step, which the deeper layers carry on. The
# bf16 update at initialization is ill-conditioned: the same plain path
# with cuDNN off (another summation order in every convolution) lies
# 0.67 from it (on an H100). Held on the whole update (all parameters,
# relative): within BF16_UPDATE_RTOL, and within BF16_ORDER_SHARE of
# that cuDNN-off distance (1.66e-2 and 0.025 of it seen); per parameter
# it is reported
BF16_UPDATE_RTOL = 5e-2
BF16_ORDER_SHARE = 0.1
# serve results held against the port on the CPU (TF32 off on the card)
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4

# published peaks (NVIDIA data sheets): HBM bytes/s and float32 FLOP/s
# outside the tensor cores, by part
_PEAKS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
          ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))
# dense bf16 tensor-core FLOP/s by part (the bound of a bf16 . bf16
# product)
_BF16_TC = (("H200", 989e12), ("H100 NVL", 835e12), ("H100 PCIe", 756e12),
            ("H100", 989e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops, key
    return 3.35e12, 67e12, "H100 SXM (assumed)"


def bf16_tc_peak(part: str) -> float:
    """Dense bf16 tensor-core FLOP/s of the part ``card_peaks`` named."""
    return next((f for key, f in _BF16_TC if key in part), 989e12)


def _dt(name: str):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def exact(a, b) -> bool:
    """Bit for bit: the same bits in a bf16 tensor (so -0 differs from
    +0), equal values (NaN nowhere) in a float32 one."""
    import torch
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))
    return bool(torch.equal(a, b))


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


def device_ms(fns, iters: int):
    """Mean device time per call of each ``fn(i)`` in ``fns`` (a dict
    name -> (fn, kernel-name substring)), from torch.profiler's CUDA
    kernel events over ``iters`` calls of each, in one profile after a
    warm call: the kernels whose names contain the substring (every
    kernel the calls launch where it is ""). Back-to-back CUDA events
    around a ~10 us kernel time the Python wrapper, not the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if DEVICE != "cuda":
        return {name: None for name in fns}
    for fn, _ in fns.values():
        fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, _ in fns.values():
            for i in range(iters):
                fn(i)
        torch.cuda.synchronize()
    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for name, (_, sub) in fns.items():
        out[name] = sum(e.time_range.elapsed_us() for e in evts
                        if sub in e.name and _owner(e, fns, sub)) \
            / 1e3 / iters
    return out


def _owner(evt, fns, sub) -> bool:
    """Whether a kernel event belongs to the entry whose substring is
    ``sub``: an empty substring takes the kernels no other entry
    names."""
    if sub:
        return True
    return not any(s and s in evt.name for _, s in fns.values())


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
    in_b = torch.empty((), dtype=in_dtype).element_size()
    out_b = torch.empty((), dtype=out_dtype).element_size()
    nbytes = n * (in_b + out_b) + 8 * c
    # enough distinct input buffers that a run of launches streams from
    # device memory, not from the 50 MB L2
    nbuf = int(min(32, max(1, -(-200e6 // (n * in_b)))))
    if in_dtype == torch.int32:
        # int8 conv accumulators: |acc| reaches 2304 * 127^2 = 3.7e7,
        # beyond 2^24, where the float32 conversion rounds; the scale
        # is a dequant (x_scale * w_scale)
        xs = [torch.randint(-40_000_000, 40_000_000, shape, generator=gen,
                            device=dev, dtype=torch.int32)
              for _ in range(nbuf)]
        scale = (torch.rand(c, generator=gen, device=dev) + 0.5) * 1e-6
    else:
        xs = [torch.randn(shape, generator=gen, device=dev).to(in_dtype)
              for _ in range(nbuf)]
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
    shift = torch.randn(c, generator=gen, device=dev)
    counts0 = kernels.launch_counts()
    got = kernels.conv_epilogue(xs[0], scale, shift, relu, out_dtype)
    ref = kernels.conv_epilogue_plain(xs[0], scale, shift, relu, out_dtype)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    # bit-exact for every dtype pair: the kernel rounds as the plain
    # version does (__int2float_rn, __fmul_rn then __fadd_rn, one
    # round-to-nearest-even cast to the output type)
    exact = bool(torch.equal(got, ref))
    bound_ms = max(nbytes / bw, 3.0 * n / flops) * 1e3
    out = {"shape": list(shape), "in": str(in_dtype)[6:],
           "out": str(out_dtype)[6:], "relu": relu,
           "max_abs_err": err, "exact": exact, "ok": exact,
           "max_abs_in": float(xs[0].abs().max()),
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
    kernels.restore_launch_counts(counts0)
    del xs, got, ref
    torch.cuda.empty_cache()
    return out


def epilogue_bwd_case(shape, bw: float, flops: float):
    """Row 5b, conv_epilogue's backward (relu fused, as the forward the
    path would differentiate), through the wrapper's autograd Function
    on the card (one launch of the bn_apply backward kernel) against
    its plain version (the bn_apply backward's) on the same inputs: dx
    bit for bit, each channel sum within SUM_RTOL of the sum of its
    terms' magnitudes."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5 + sum(shape))
    c = shape[-1]
    n = int(np.prod(shape))
    x = torch.randn(shape, generator=gen, device=dev)
    dy = torch.randn(shape, generator=gen, device=dev)
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    shift = 0.5 * torch.randn(c, generator=gen, device=dev)
    counts0 = kernels.launch_counts()
    leaves = [v.clone().requires_grad_(True) for v in (x, scale, shift)]
    y = kernels.conv_epilogue(*leaves, True)
    dx, ds, dt = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    yp = kernels.conv_epilogue_plain(x, scale, shift, True)
    px, ps, pt = kernels.bn_apply_bwd_plain(x, yp, dy, scale, True)
    axes = tuple(range(len(shape) - 1))
    dym = torch.where(yp > 0, dy, torch.zeros_like(dy))
    mag_s, mag_t = (dym * x).abs().sum(axes), dym.abs().sum(axes)
    torch.cuda.synchronize()
    es, et = (ds - ps).abs(), (dt - pt).abs()
    out = {"shape": list(shape), "relu": True,
           "dx_err": float((dx - px).abs().max()),
           "sum_err": float(max(es.max(), et.max())),
           "sum_rel": float(max((es / mag_s.clamp_min(1e-30)).max(),
                                (et / mag_t.clamp_min(1e-30)).max())),
           "bn_apply_bwd_launches": kernels.launch_counts()["bn_apply_bwd"]
           - counts0["bn_apply_bwd"],
           "conv_epilogue_bwd_launches":
           kernels.launch_counts()["conv_epilogue_bwd"]
           - counts0["conv_epilogue_bwd"]}
    out["ok"] = bool(out["dx_err"] == 0.0
                     and bool((es <= SUM_RTOL * mag_s).all())
                     and bool((et <= SUM_RTOL * mag_t).all())
                     and out["bn_apply_bwd_launches"] == 1
                     and out["conv_epilogue_bwd_launches"] == 1)
    del dx, px, dym, yp
    out["bound_ms"], out["bound_by"] = bound(16 * n + 12 * c, 6 * n, bw,
                                             flops)
    out["ms"] = cuda_time_ms(
        lambda i: torch.autograd.grad(y, leaves, dy, retain_graph=True), 20)
    out["plain_ms"] = cuda_time_ms(
        lambda i: kernels.bn_apply_bwd_plain(x, y.detach(), dy, scale,
                                             True), 20)
    out["device_ms"] = device_ms({"bwd": (
        lambda i: torch.autograd.grad(y, leaves, dy, retain_graph=True),
        "cxn_bn_bwd")}, 20)["bwd"]
    kernels.restore_launch_counts(counts0)
    del x, dy, y, leaves
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
    """(M, K, N, A transposed, B transposed, operand dtypes) of every
    matmul launch of one training step: per pallas_fullc layer the
    forward x.w, and the backward dy.w^T and x^T.dy (transposed operands
    are strided views). Under dtype = bfloat16 x and w are bf16 and dy,
    the cotangent of the f32 output, is f32."""
    out = []
    for li in range(len(net.graph.layers)):
        if net.graph.effective_type(li) == "pallas_fullc":
            p = net.layer_objs[li].param
            m, k, n = batch, p.num_input_node, p.num_hidden
            op = p.compute_dtype
            out += [(m, k, n, False, False, (op, op)),
                    (m, n, k, False, True, ("float32", op)),
                    (k, m, n, True, False, (op, "float32"))]
    return out


def bound(nbytes: float, ops: float, bw: float, flops: float):
    """(bound ms, what bounds it) of a function moving ``nbytes`` and
    doing ``ops`` float32 operations."""
    return max(nbytes / bw, ops / flops) * 1e3, \
        "bytes" if nbytes / bw >= ops / flops else "operations"


def bn_case(shape, bw: float, flops: float, dtype: str = "float32"):
    """bn_apply forward and backward (relu fused, as on the path) on the
    card against their plain versions on the same inputs, with times
    and bounds, on ``dtype`` activations (float32 scale and shift).
    Forward and dx must agree bit for bit (in bf16 the same bits); each
    channel sum within SUM_RTOL of the sum of its terms' magnitudes (the
    f32 sums run in another order than torch.sum's)."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    dt = _dt(dtype)
    esz = torch.empty((), dtype=dt).element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape))
    c = shape[-1]
    n = int(np.prod(shape))
    nbuf = int(min(16, max(1, -(-200e6 // (n * esz)))))
    xs = [torch.randn(shape, generator=gen, device=dev).to(dt)
          for _ in range(nbuf)]
    dys = [torch.randn(shape, generator=gen, device=dev).to(dt)
           for _ in range(nbuf)]
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    shift = 0.5 * torch.randn(c, generator=gen, device=dev)
    counts0 = kernels.launch_counts()
    y = kernels.bn_apply_fwd(xs[0], scale, shift, True)
    yp = kernels.bn_apply_plain(xs[0], scale, shift, True)
    dx, ds, dsh = kernels.bn_apply_bwd(xs[0], y, dys[0], scale, True)
    px, ps, pt = kernels.bn_apply_bwd_plain(xs[0], yp, dys[0], scale, True)
    axes = tuple(range(len(shape) - 1))
    dym = torch.where(yp > 0, dys[0], torch.zeros_like(dys[0]))
    mag_s = (dym * xs[0]).float().abs().sum(axes)
    mag_t = dym.float().abs().sum(axes)
    torch.cuda.synchronize()
    es, et = (ds - ps).abs(), (dsh - pt).abs()
    out = {"shape": list(shape), "dtype": dtype,
           "fwd_err": float((y.float() - yp.float()).abs().max()),
           "dx_err": float((dx.float() - px.float()).abs().max()),
           "fwd_exact": exact(y, yp), "dx_exact": exact(dx, px),
           "sum_err": float(max(es.max(), et.max())),
           "sum_rel": float(max((es / mag_s.clamp_min(1e-30)).max(),
                                (et / mag_t.clamp_min(1e-30)).max()))}
    out["ok"] = bool(out["fwd_exact"] and out["dx_exact"]
                     and bool((es <= SUM_RTOL * mag_s).all())
                     and bool((et <= SUM_RTOL * mag_t).all()))
    del yp, dx, px, dym, ds, dsh, ps, pt
    # forward: read x, write y (+ scale, shift); mul, add, max each
    out["fwd_bound_ms"], out["fwd_bound_by"] = bound(
        2 * esz * n + 8 * c, 3 * n, bw, flops)
    # backward: read x, y, dy, write dx (+ scale, two sums); select,
    # mul, add 0, mul, two adds each
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(
        4 * esz * n + 12 * c, 6 * n, bw, flops)
    ys = [kernels.bn_apply_fwd(x, scale, shift, True) for x in xs]
    iters = int(min(200, max(10, 4e9 // (2 * esz * n))))
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
    dev = device_ms({
        "fwd": (lambda i: kernels.bn_apply_fwd(xs[i % nbuf], scale, shift,
                                               True), "cxn_bn_fwd"),
        "bwd": (lambda i: kernels.bn_apply_bwd(xs[i % nbuf], ys[i % nbuf],
                                               dys[i % nbuf], scale, True),
                "cxn_bn_bwd")}, iters)
    out["fwd_device_ms"], out["bwd_device_ms"] = dev["fwd"], dev["bwd"]
    # comparison and timing launches are not main-path launches
    kernels.restore_launch_counts(counts0)
    del xs, dys, ys, y
    torch.cuda.empty_cache()
    return out


def matmul_case(m: int, k: int, n: int, ta: bool, tb: bool, bw: float,
                flops: float, dtypes=("float32", "float32"),
                tc_flops: float = 989e12, expect_route=None):
    """The matmul kernel on the card against its plain version for an
    (M, K) . (K, N) product whose operands may be transposed views, each
    of its own dtype (``dtypes``); every output within SUM_RTOL of
    sum_k |a * b|. The library call: torch.matmul on two float32
    operands; torch.mm(a, b, out_dtype=torch.float32) on two bf16 ones
    (null, with the reason, where this torch lacks it); none for mixed
    operands (no one call takes them). The bound's operations run at
    the bf16 tensor-core rate ``tc_flops`` for a bf16 . bf16 product,
    at the float32 rate otherwise."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    da, db = _dt(dtypes[0]), _dt(dtypes[1])
    gen = torch.Generator(device=dev).manual_seed(SEED + m + 3 * k + 7 * n)
    a = torch.randn((k, m) if ta else (m, k), generator=gen,
                    device=dev).to(da)
    b = torch.randn((n, k) if tb else (k, n), generator=gen,
                    device=dev).to(db)
    A, B = (a.t() if ta else a), (b.t() if tb else b)
    counts0 = kernels.launch_counts()
    got = kernels.matmul_kernel(A, B)
    ref = kernels.matmul_plain(A, B)
    mag = torch.matmul(A.float().abs(), B.float().abs())
    torch.cuda.synchronize()
    err = (got - ref).abs()
    out = {"mkn": [m, k, n], "a_transposed": ta, "b_transposed": tb,
           "dtypes": list(dtypes),
           "max_abs_err": float(err.max()),
           "rel_err": float((err / mag.clamp_min(1e-30)).max()),
           "ok": bool((err <= SUM_RTOL * mag).all())}
    nbytes = a.element_size() * m * k + b.element_size() * k * n + 4 * m * n
    both_bf16 = da == db == torch.bfloat16
    out["bound_ms"], out["bound_by"] = bound(
        nbytes, 2 * m * n * k, bw, tc_flops if both_bf16 else flops)
    plan = kernels.matmul_plan(
        m, k, n, (kernels._mat_strides(A), kernels._mat_strides(B)),
        (da, db), aligned=A.data_ptr() % 16 == 0 and B.data_ptr() % 16 == 0)
    if DEVICE == "cuda" and kernels.matmul_kernel.last_plan != plan:
        raise RuntimeError("matmul launched another plan than %s" % plan)
    out["route"], out["splits"] = plan["route"], plan["splits"]
    out["blocks"] = plan["blocks"]
    out["ok"] = out["ok"] and (expect_route is None
                               or plan["route"] == expect_route)
    out["expect_route"] = expect_route
    out["ms"] = cuda_time_ms(lambda i: kernels.matmul_kernel(A, B), 50)
    out["plain_ms"] = cuda_time_ms(lambda i: kernels.matmul_plain(A, B), 50)
    out["library_ms"] = None
    lib = None
    if da == db == torch.float32:
        lib = lambda i: torch.matmul(A, B)  # noqa: E731
        out["library"] = "torch.matmul"
    elif both_bf16:
        out["library"] = "torch.mm(a, b, out_dtype=torch.float32)"
        try:
            torch.mm(A, B, out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            out["library_missing"] = "%s: %s" % (type(e).__name__,
                                                 str(e)[:160])
        else:
            lib = lambda i: torch.mm(A, B, out_dtype=torch.float32)  # noqa
    else:
        out["library"] = "none: no one call multiplies mixed dtypes"
    fns = {"kernel": (lambda i: kernels.matmul_kernel(A, B), "cxn_sgemm")}
    if lib is not None:
        out["library_ms"] = cuda_time_ms(lib, 50)
        fns["library"] = (lib, "")
    dev = device_ms(fns, 50)
    out["device_ms"] = dev["kernel"]
    out["library_device_ms"] = dev.get("library")
    kernels.restore_launch_counts(counts0)
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


def max_err(a, b) -> float:
    """Largest |a - b| where neither is NaN; inf if NaN places differ."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return float("inf")
    d = (torch.where(na, 0.0, a) - torch.where(nb, 0.0, b)).abs()
    return float(d.max()) if d.numel() else 0.0


def _route(plan) -> str:
    return "%s/v%d" % (plan["route"], plan["v"])


def relu_pool_case(shape, k: int, bw: float, flops: float,
                   nan: bool = False, timed: bool = True,
                   dtype: str = "float32", misalign: bool = False,
                   expect: str = None):
    """relu_max_pool forward and backward on the card against their
    plain versions on the same ``dtype`` inputs, bit for bit: x in steps
    of 0.5 (positive windows hold tied maxima, every one credited), the
    backward also with the cotangent as a permuted view (read through
    its strides). ``misalign``: x starts one element past an aligned
    base. Each launch's route (``relu_max_pool_plan``) is printed, and
    the dense launches must take ``expect`` (``"slide/v8"`` etc.) where
    it is given. With ``timed``: kernel, plain and reference times
    (F.relu + F.max_pool2d, and their autograd backward), the kernels'
    device time per call from the profiler, and the bounds."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    dt = _dt(dtype)
    esz = torch.empty((), dtype=dt).element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape) + k)
    b, h, w, c = shape
    oshape = (b, h - k + 1, w - k + 1, c)
    n_in, n_out = int(np.prod(shape)), int(np.prod(oshape))
    nbuf = int(min(8, max(1, -(-200e6 // (esz * n_in))))) if timed else 1
    xs = [(torch.round(2 * torch.randn(shape, generator=gen, device=dev))
           / 2).to(dt) for _ in range(nbuf)]
    if misalign:
        buf = torch.empty(n_in + 1, dtype=dt, device=dev)
        buf[1:].copy_(xs[0].view(-1))
        xs[0] = buf[1:].view(shape)
    if nan:
        xs[0].view(-1)[::997] = float("nan")
    dys = [torch.randn(oshape, generator=gen, device=dev).to(dt)
           for _ in range(nbuf)]
    counts0 = kernels.launch_counts()
    strided0 = kernels.relu_max_pool_bwd.strided_dy
    y = kernels.relu_max_pool_fwd(xs[0], k)
    fplan = kernels.relu_max_pool_fwd.last_plan
    yp = kernels.relu_max_pool_plain(xs[0], k)
    dx = kernels.relu_max_pool_bwd(xs[0], y, dys[0], k)
    bplan = kernels.relu_max_pool_bwd.last_plan
    dxp = kernels.relu_max_pool_bwd_plain(xs[0], yp, dys[0], k)
    dyv = dys[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    dxv = kernels.relu_max_pool_bwd(xs[0], y, dyv, k)
    vplan = kernels.relu_max_pool_bwd.last_plan
    # credits beyond one per positive window: how many ties the
    # backward resolved
    r = torch.clamp_min(xs[0], 0)
    pos = yp > 0
    credits = sum(int(((r[:, di:di + oshape[1], dj:dj + oshape[2]] == yp)
                       & pos).sum()) for di in range(k) for dj in range(k))
    torch.cuda.synchronize()
    out = {"shape": list(shape), "k": k, "nan": nan, "dtype": dtype,
           "misaligned": misalign,
           "route_fwd": _route(fplan), "route_bwd": _route(bplan),
           "route_bwd_strided_dy": _route(vplan),
           "fwd_plan": {key: fplan[key] for key in
                        ("rows", "tw", "ct", "blocks")},
           "bwd_plan": {key: bplan[key] for key in
                        ("rows", "tw", "ct", "blocks")},
           "expect": expect,
           "fwd_err": max_err(y.float(), yp.float()),
           "bwd_err": max_err(dx.float(), dxp.float()),
           "bwd_strided_dy_err": max_err(dxv.float(), dxp.float()),
           "fwd_exact": bits_equal(y, yp),
           "bwd_exact": bits_equal(dx, dxp) and bits_equal(dxv, dxp),
           "tie_credits": credits - int(pos.sum()),
           "nan_outputs": int(torch.isnan(y).sum())}
    out["ok"] = out["fwd_exact"] and out["bwd_exact"] and (
        expect is None or out["route_fwd"] == out["route_bwd"] == expect)
    del yp, dx, dxp, dyv, dxv, r, pos
    if timed:
        # forward: read x, write y; k*k maxima per output. backward: read
        # x, y, dy, write dx; k*k compares and adds per input
        out["fwd_bound_ms"], out["fwd_bound_by"] = bound(
            esz * (n_in + n_out), k * k * n_out, bw, flops)
        out["bwd_bound_ms"], out["bwd_bound_by"] = bound(
            2 * esz * (n_in + n_out), 2 * k * k * n_in, bw, flops)
        ys = [kernels.relu_max_pool_fwd(x, k) for x in xs]
        iters = int(min(40, max(5, 2e9 // (esz * (n_in + n_out)))))
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
        dev_ms = device_ms({
            "fwd": (lambda i: kernels.relu_max_pool_fwd(xs[i % nbuf], k),
                    "cxn_relu_max_pool_fwd"),
            "bwd": (lambda i: kernels.relu_max_pool_bwd(
                xs[i % nbuf], ys[i % nbuf], dys[i % nbuf], k),
                "cxn_relu_max_pool_bwd")}, iters)
        out["fwd_device_ms"], out["bwd_device_ms"] = \
            dev_ms["fwd"], dev_ms["bwd"]
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
    kernels.restore_launch_counts(counts0)
    kernels.relu_max_pool_bwd.strided_dy = strided0
    del xs, dys, y
    torch.cuda.empty_cache()
    return out


def relu_pool_section(bw: float, flops: float, dtype: str = "float32"):
    """Every relu_max_pool shape of kaiming-224's batch-128 training
    step (each must take the slide route at 16-byte vectors), plus
    extra cases: a ragged channel count (C = 3), a NaN case, a ragged
    last strip and column tile, k = 2, k = 5 (the generic route), C =
    72 and C = 68 (bf16: C = 72 slides 8-wide, C = 68 is no multiple
    of 8 and takes the generic route 4-wide), and an x one element
    past an aligned base (the scalar route). The "kernel section" is
    the profiler's device time per call summed over the path."""
    from cxxnet_tpu_torch.nnet.net import FuncNet
    knet = FuncNet(_configured(kaiming_cfg(TRAIN_BATCH)), TRAIN_BATCH)
    shapes = path_relu_pool_shapes(knet, TRAIN_BATCH)
    if len(shapes) != KAIMING_LAUNCHES["relu_max_pool_fwd"]:
        raise RuntimeError("expected %d fused pools, the net has %d"
                           % (KAIMING_LAUNCHES["relu_max_pool_fwd"],
                              len(shapes)))
    wide = "slide/v%d" % (8 if dtype == "bfloat16" else 4)
    path = [relu_pool_case(s[:4], s[4], bw, flops, dtype=dtype,
                           expect=wide) for s in shapes]

    def extra(shape, k, **kw):
        return relu_pool_case(shape, k, bw, flops, timed=False,
                              dtype=dtype, **kw)
    extras = [extra((TRAIN_BATCH, 37, 37, 3), 3, expect="generic/v1"),
              extra((16, 18, 18, 256), 3, nan=True, expect=wide),
              extra((8, 9, 9, 12), 2),
              extra((4, 23, 29, 64), 3, expect=wide),
              extra((16, 20, 20, 64), 2, expect=wide),
              extra((8, 15, 15, 64), 5, expect="generic/v4"),
              extra((8, 18, 18, 72), 3, expect=wide),
              extra((8, 18, 18, 68), 3,
                    expect="generic/v4" if dtype == "bfloat16" else wide),
              extra((8, 18, 18, 64), 3, misalign=True,
                    expect="generic/v1")]
    keys = ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "reference_fwd_ms",
            "fwd_device_ms", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
            "reference_bwd_ms", "bwd_device_ms")
    cases = path + extras
    step = {key: (sum(c[key] for c in path)
                  if all(c[key] is not None for c in path) else None)
            for key in keys}
    return {"ok": all(c["ok"] for c in cases), "dtype": dtype,
            "launches_per_step": len(path),
            "step_sum": step,
            "kernel_section_ms": {"fwd": step["fwd_device_ms"],
                                  "bwd": step["bwd_device_ms"]},
            "routes": [[c["route_fwd"], c["route_bwd"],
                        c["route_bwd_strided_dy"]] for c in cases],
            "fwd_max_abs_err": max(c["fwd_err"] for c in cases),
            "bwd_max_abs_err": max(max(c["bwd_err"], c["bwd_strided_dy_err"])
                                   for c in cases),
            "fwd_bound_by": "bytes" if all(c["fwd_bound_by"] == "bytes"
                                           for c in path) else "operations",
            "bwd_bound_by": "bytes" if all(c["bwd_bound_by"] == "bytes"
                                           for c in path) else "operations",
            "reference": "F.relu + F.max_pool2d (two calls; its backward "
                         "credits one tied maximum per window)",
            "path_cases": path, "extra_cases": extras}


def train_cfg_bf16(batch: int):
    """The Inception-BN training slice at the repo's own mixed
    precision: bench.py's ``dtype = grad_dtype = momentum_dtype =
    bfloat16`` (``example/ImageNet/Inception-BN.conf`` trains at
    ``dtype = bfloat16``)."""
    return train_cfg(batch) + BENCH_BF16


def kaiming_cfg_bf16(batch: int, pallas_pool: int = 1):
    """kaiming-224 as bench.py's kaiming entry trains it: ``dtype =
    momentum_dtype = bfloat16``."""
    return kaiming_cfg(batch, pallas_pool) + [
        ("dtype", "bfloat16"), ("momentum_dtype", "bfloat16")]


def _step_of(cases, keys, counts=None):
    """Per-step sums of ``keys`` over cases (each weighted by its
    count); None for a key some case lacks a value of."""
    out = {}
    for k in keys:
        vals = [c[k] for c in cases]
        out[k] = None if any(v is None for v in vals) else sum(
            v * (counts[i] if counts else 1) for i, v in enumerate(vals))
    return out


def training_kernel_section(bw: float, flops: float, tc_flops: float,
                            bf16: bool):
    """The training kernels on the card against their plain versions,
    at every shape of their paths: bn_apply at Inception-BN-224's 69
    batch-norm inputs (batch 128), matmul at fc1's three products,
    relu_max_pool at kaiming-224's three fused pools; plus a ragged
    matmul and the relu_max_pool extra cases. With ``bf16`` the bf16
    instantiations at the bench set: bn_apply on bf16 activations,
    matmul's bf16 . bf16 forward and f32 . bf16 and bf16 . f32
    backward products, relu_max_pool on bf16. Forward and dx bit for
    bit, sums within SUM_RTOL."""
    from cxxnet_tpu_torch.nnet.net import FuncNet
    dtype = "bfloat16" if bf16 else "float32"
    cfg = train_cfg_bf16 if bf16 else train_cfg
    expected = TRAIN_BF16_LAUNCHES if bf16 else TRAIN_LAUNCHES
    sfx = "_bf16" if bf16 else ""
    tnet = FuncNet(_configured(cfg(TRAIN_BATCH)), TRAIN_BATCH)
    bn_shapes = path_bn_shapes(tnet, TRAIN_BATCH)
    if len(bn_shapes) != expected["bn_apply_fwd" + sfx]:
        raise RuntimeError("expected %d batch norms, the net has %d"
                           % (expected["bn_apply_fwd" + sfx],
                              len(bn_shapes)))
    bn_cases = {}
    for sh in sorted(set(bn_shapes), key=lambda v: -int(np.prod(v))):
        bn_cases[sh] = bn_case(sh, bw, flops, dtype)
    cases = list(bn_cases.values())
    counts = [bn_shapes.count(sh) for sh in bn_cases]
    bn = {"ok": all(c["ok"] for c in cases),
          "launches_per_step": len(bn_shapes),
          "distinct_path_shapes": len(bn_cases),
          "step_sum": _step_of(cases, ("fwd_ms", "fwd_plain_ms",
                                       "fwd_bound_ms", "bwd_ms",
                                       "bwd_plain_ms", "bwd_bound_ms",
                                       "fwd_device_ms", "bwd_device_ms"),
                               counts),
          "fwd_max_abs_err": max(c["fwd_err"] for c in cases),
          "bwd_max_abs_err": max(max(c["dx_err"], c["sum_err"])
                                 for c in cases),
          "bwd_sum_max_rel": max(c["sum_rel"] for c in cases),
          "sum_rtol": SUM_RTOL,
          "fwd_bound_by": "bytes" if all(c["fwd_bound_by"] == "bytes"
                                         for c in cases) else "operations",
          "bwd_bound_by": "bytes" if all(c["bwd_bound_by"] == "bytes"
                                         for c in cases) else "operations",
          "cases": [dict(c, count=n) for c, n in zip(cases, counts)]}
    products = path_matmul_products(tnet, TRAIN_BATCH)
    if len(products) != expected["matmul" + sfx]:
        raise RuntimeError("expected %d matmul launches per step, the net "
                           "has %d" % (expected["matmul" + sfx],
                                       len(products)))
    # fc1's bf16 . bf16 forward must take the tensor cores
    mm_path = [matmul_case(*p[:5], bw, flops, p[5], tc_flops,
                           "wgmma" if p[5] == ("bfloat16", "bfloat16")
                           else "fma") for p in products]
    mm_extra = [matmul_case(77, 1000, 129, False, True, bw, flops,
                            (dtype, dtype), tc_flops, "fma")]
    if bf16:
        # ragged on the tensor cores (TMA fills the edges with zeros),
        # and a B whose 129-element rows break TMA's 16-byte stride rule
        mm_extra += [matmul_case(77, 1000, 136, False, False, bw, flops,
                                 (dtype, dtype), tc_flops, "wgmma"),
                     matmul_case(77, 1000, 129, False, False, bw, flops,
                                 (dtype, dtype), tc_flops, "fma")]
    mm = {"ok": all(c["ok"] for c in mm_path + mm_extra),
          "launches_per_step": len(products),
          "routes": [[c["route"], c["splits"]] for c in mm_path],
          "step_sum": _step_of(mm_path, ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "device_ms",
                                         "library_device_ms")),
          "max_abs_err": max(c["max_abs_err"] for c in mm_path + mm_extra),
          "max_rel_err": max(c["rel_err"] for c in mm_path + mm_extra),
          "rtol": SUM_RTOL,
          "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                     for c in mm_path) else "operations",
          "path_cases": mm_path, "extra_cases": mm_extra}
    rmp = relu_pool_section(bw, flops, dtype)
    return {"ok": bn["ok"] and mm["ok"] and rmp["ok"], "bn_apply": bn,
            "matmul": mm, "relu_max_pool": rmp}


def bits_equal(a, b) -> bool:
    """The same bits where neither is NaN (so -0 differs from +0) and
    NaN at the same places (a NaN's payload aside)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    iv = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return bool(torch.equal(torch.where(na, zero, a).view(iv),
                            torch.where(nb, zero, b).view(iv)))


def path_concat_shapes(net, batch: int):
    """(branch widths, pool position, k, mode, H, W, batch) of every
    fused concat of ``net`` (its pool_concat launches per forward, and
    per backward)."""
    out = []
    for li, (pos, k, mode) in sorted(net.fused_concats.items()):
        ins = net.layer_objs[li].in_shapes
        out.append((tuple(s.ch for s in ins), pos, k, mode, ins[0].y,
                    ins[0].x, batch))
    return out


def pool_concat_case(widths, pos: int, k: int, mode: str, h: int, w: int,
                     batch: int, bw: float, flops: float,
                     dtype: str = "float32", nan: bool = False,
                     grid: bool = True, timed: bool = True):
    """pool_concat forward and the pool branch's backward on the card
    against their plain versions on the same inputs, the same bits:
    inputs in steps of 0.5 (``grid``: tied maxima, exact zeros) or
    N(0, 9) (avg sums that round), optionally NaN in the pool branch;
    the forward also from channels-last views of the branches (read
    through their strides), the backward also from a permuted
    cotangent. With ``timed``: kernel, plain and reference times (F.pad
    + F.max_pool2d / F.avg_pool2d + torch.cat, and its autograd
    backward) and the bounds."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    dt = _dt(dtype)
    esz = torch.empty((), dtype=dt).element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(widths) + k + h)
    ctot, cp = sum(widths), widths[pos]
    off = sum(widths[:pos])
    n_out, n_pool = batch * h * w * ctot, batch * h * w * cp
    nbuf = 2 if timed else 1

    def draw(shape):
        v = torch.randn(shape, generator=gen, device=dev)
        return (torch.round(2 * v) / 2 if grid else 3 * v).to(dt)
    xs = [[draw((batch, h, w, c)) for c in widths] for _ in range(nbuf)]
    if nan:
        xs[0][pos].view(-1)[::997] = float("nan")
    dys = [torch.randn((batch, h, w, ctot), generator=gen, device=dev).to(dt)
           for _ in range(nbuf)]
    counts0 = kernels.launch_counts()
    out = kernels.pool_concat_fwd(xs[0], pos, k, mode)
    ref = kernels.pool_concat_plain(xs[0], pos, k, mode)
    views = [x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
             for x in xs[0]]
    outv = kernels.pool_concat_fwd(views, pos, k, mode)
    dx = kernels.pool_concat_bwd(xs[0][pos], out, dys[0], off, k, mode)
    dxp = kernels.pool_concat_bwd_plain(xs[0][pos], ref, dys[0], off, k,
                                        mode)
    dyv = dys[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    dxv = kernels.pool_concat_bwd(xs[0][pos], out, dyv, off, k, mode)
    torch.cuda.synchronize()
    res = {"widths": list(widths), "pos": pos, "k": k, "mode": mode,
           "hw": [h, w], "batch": batch, "dtype": dtype, "nan": nan,
           "grid": grid,
           "fwd_err": max_err(out.float(), ref.float()),
           "bwd_err": max_err(dx.float(), dxp.float()),
           "fwd_exact": bits_equal(out, ref) and bits_equal(outv, ref),
           "bwd_exact": bits_equal(dx, dxp) and bits_equal(dxv, dxp),
           "nan_outputs": int(torch.isnan(out).sum())}
    res["ok"] = res["fwd_exact"] and res["bwd_exact"]
    del ref, views, outv, dx, dxp, dyv, dxv
    if timed:
        # forward: read every branch, write the output; k*k operations
        # per pooled element. backward: read dy's segment and write dx,
        # and under max also read x and the output's segment (avg reads
        # no x); k*k compares (or products) and adds per input element
        res["fwd_bound_ms"], res["fwd_bound_by"] = bound(
            2 * esz * n_out, k * k * n_pool, bw, flops)
        res["bwd_bound_ms"], res["bwd_bound_by"] = bound(
            esz * n_pool * (4 if mode == "max" else 2), 2 * k * k * n_pool,
            bw, flops)
        outs = [kernels.pool_concat_fwd(x, pos, k, mode) for x in xs]
        iters = 20
        res["fwd_ms"] = cuda_time_ms(
            lambda i: kernels.pool_concat_fwd(xs[i % nbuf], pos, k, mode),
            iters)
        res["fwd_plain_ms"] = cuda_time_ms(
            lambda i: kernels.pool_concat_plain(xs[i % nbuf], pos, k, mode),
            iters)
        res["bwd_ms"] = cuda_time_ms(
            lambda i: kernels.pool_concat_bwd(xs[i % nbuf][pos],
                                              outs[i % nbuf], dys[i % nbuf],
                                              off, k, mode), iters)
        res["bwd_plain_ms"] = cuda_time_ms(
            lambda i: kernels.pool_concat_bwd_plain(
                xs[i % nbuf][pos], outs[i % nbuf], dys[i % nbuf], off, k,
                mode), iters)
        del outs
        p = k // 2
        pool = F.max_pool2d if mode == "max" else F.avg_pool2d

        def ref_fwd(bs):
            xp = F.pad(bs[pos].permute(0, 3, 1, 2), (p, p, p, p))
            y = pool(xp, k, 1).permute(0, 2, 3, 1)
            return torch.cat(list(bs[:pos]) + [y] + list(bs[pos + 1:]), 3)
        res["reference_fwd_ms"] = cuda_time_ms(
            lambda i: ref_fwd(xs[i % nbuf]), iters)
        leaves = [[x.clone().requires_grad_(True) for x in b] for b in xs]
        graphs = [ref_fwd(b) for b in leaves]
        res["reference_bwd_ms"] = cuda_time_ms(
            lambda i: torch.autograd.grad(graphs[i % nbuf],
                                          leaves[i % nbuf], dys[i % nbuf],
                                          retain_graph=True), iters)
        del leaves, graphs
    # comparison and timing launches are not main-path launches
    kernels.restore_launch_counts(counts0)
    del xs, dys, out
    torch.cuda.empty_cache()
    return res


def pool_concat_section(bw: float, flops: float, dtype: str):
    """pool_concat at every fused concat of the tower's batch-128 step
    on ``dtype`` (the same shapes serve at f32), plus a ragged case
    (widths not multiples of 8, k = 5, pool branch in the middle), a
    NaN case and an N(0, 9) avg case."""
    from cxxnet_tpu_torch.nnet.net import FuncNet
    cfg = tower_train_cfg_bf16 if dtype == "bfloat16" else tower_train_cfg
    tnet = FuncNet(_configured(cfg(TRAIN_BATCH)), TRAIN_BATCH)
    shapes = path_concat_shapes(tnet, TRAIN_BATCH)
    if len(shapes) != len(TOWER_FUSED[dtype]):
        raise RuntimeError("expected %d fused concats, the tower has %d"
                           % (len(TOWER_FUSED[dtype]), len(shapes)))
    path = [pool_concat_case(*sh, bw, flops, dtype) for sh in shapes]
    extra = [pool_concat_case((13, 7, 5, 19), 2, 5, "max", 28, 28, 16, bw,
                              flops, dtype, timed=False),
             pool_concat_case((13, 7, 5, 19), 2, 5, "avg", 28, 28, 16, bw,
                              flops, dtype, timed=False),
             pool_concat_case((64, 96, 128, 928), 3, 3, "max", 14, 14, 32,
                              bw, flops, dtype, nan=True, timed=False),
             pool_concat_case((64, 64, 96, 192), 3, 3, "avg", 28, 28, 16,
                              bw, flops, dtype, grid=False, timed=False)]
    keys = ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "reference_fwd_ms",
            "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "reference_bwd_ms")
    cases = path + extra
    return {"ok": all(c["ok"] for c in cases), "dtype": dtype,
            "launches_per_step": len(path),
            "step_sum": {k: sum(c[k] for c in path) for k in keys},
            "fwd_max_abs_err": max(c["fwd_err"] for c in cases),
            "bwd_max_abs_err": max(c["bwd_err"] for c in cases),
            "fwd_bound_by": "bytes" if all(c["fwd_bound_by"] == "bytes"
                                           for c in path) else "operations",
            "bwd_bound_by": "bytes" if all(c["bwd_bound_by"] == "bytes"
                                           for c in path) else "operations",
            "reference": "F.pad + F.max_pool2d / F.avg_pool2d + torch.cat "
                         "(three calls; no one call computes it)",
            "path_cases": path, "extra_cases": extra}


def epilogue_bwd_bf16_case(shape, xd: str, yd: str, bw: float,
                           flops: float):
    """conv_epilogue's VJP with a bf16 x or y (relu fused) on the card:
    ``cxn_conv_epilogue_bwd`` against its plain version on the same
    inputs, dx the same bits, each channel sum within SUM_RTOL of the
    sum of its terms' magnitudes; once through the autograd Function
    (one launch counted); times and the bound."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    tx, ty = _dt(xd), _dt(yd)
    ex = torch.empty((), dtype=tx).element_size()
    ey = torch.empty((), dtype=ty).element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 + sum(shape))
    c = shape[-1]
    n = int(np.prod(shape))
    x = torch.randn(shape, generator=gen, device=dev).to(tx)
    dy = torch.randn(shape, generator=gen, device=dev).to(ty)
    # exact zeros, some negative, in dy: the + 0 of dx shows
    dy.view(-1)[::101] = -0.0
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    shift = 0.5 * torch.randn(c, generator=gen, device=dev)
    counts0 = kernels.launch_counts()
    y = kernels.conv_epilogue(x, scale, shift, True, ty)
    dx, ds, dt = kernels.conv_epilogue_bwd(x, y, dy, scale, True)
    px, ps, pt = kernels.conv_epilogue_bwd_plain(x, y, dy, scale, True)
    leaves = [v.clone().requires_grad_(True) for v in (x, scale, shift)]
    fy = kernels.conv_epilogue(*leaves, True, ty)
    before = kernels.launch_counts()["conv_epilogue_bwd_bf16"]
    gx, _, _ = torch.autograd.grad(fy, leaves, dy)
    fn_launches = kernels.launch_counts()["conv_epilogue_bwd_bf16"] - before
    axes = tuple(range(len(shape) - 1))
    dym = torch.where(y > 0, dy, torch.zeros_like(dy)).float()
    mag_s, mag_t = (dym * x.float()).abs().sum(axes), dym.abs().sum(axes)
    torch.cuda.synchronize()
    es, et = (ds - ps).abs(), (dt - pt).abs()
    out = {"shape": list(shape), "x": xd, "y": yd, "relu": True,
           "dx_err": float((dx.float() - px.float()).abs().max()),
           "dx_exact": bits_equal(dx, px) and bits_equal(gx, px),
           "sum_err": float(max(es.max(), et.max())),
           "sum_rel": float(max((es / mag_s.clamp_min(1e-30)).max(),
                                (et / mag_t.clamp_min(1e-30)).max())),
           "function_launches": fn_launches}
    out["ok"] = bool(out["dx_exact"] and bool((es <= SUM_RTOL * mag_s).all())
                     and bool((et <= SUM_RTOL * mag_t).all())
                     and fn_launches == 1)
    del dx, px, gx, dym, fy, leaves
    # read x, y, dy, write dx (+ scale, two sums); select, mul, add 0,
    # mul, two adds per element
    out["bound_ms"], out["bound_by"] = bound(
        n * (2 * ex + 2 * ey) + 12 * c, 6 * n, bw, flops)
    out["ms"] = cuda_time_ms(
        lambda i: kernels.conv_epilogue_bwd(x, y, dy, scale, True), 20)
    out["plain_ms"] = cuda_time_ms(
        lambda i: kernels.conv_epilogue_bwd_plain(x, y, dy, scale, True), 20)
    out["device_ms"] = device_ms({"bwd": (
        lambda i: kernels.conv_epilogue_bwd(x, y, dy, scale, True),
        "cxn_bn_bwd")}, 20)["bwd"]
    kernels.restore_launch_counts(counts0)
    del x, y, dy
    torch.cuda.empty_cache()
    return out


def path_bias_shapes(net, batch: int):
    """Shape of every conv or fullc output that adds a bias (one
    bias_grad_bf16 launch each per bf16 training step)."""
    shapes = []
    for li in range(len(net.graph.layers)):
        t = net.graph.effective_type(li)
        layer = net.layer_objs[li]
        if t in ("conv", "fullc") and layer.param.no_bias == 0:
            s = layer.out_shapes[0]
            shapes.append((batch, s.x) if s.is_mat
                          else (batch, s.y, s.x, s.ch))
    return shapes


def bias_grad_case(shape, bw: float, flops: float):
    """The bf16 bias gradient on the card against its plain version (the
    same bits), also from a permuted cotangent (4-D); kernel and plain
    times, torch.sum's (f32 accumulation, one rounding: another
    function's bits, the yardstick of a reduction), and the bound."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3 + sum(shape))
    n, c = int(np.prod(shape)), shape[-1]
    dy = (3 * torch.randn(shape, generator=gen, device=dev)).to(
        torch.bfloat16)
    counts0 = kernels.launch_counts()
    got = kernels.bias_grad_bf16(dy)
    ref = kernels.bias_grad_bf16_plain(dy)
    same = bits_equal(got, ref)
    if len(shape) == 4:
        dyv = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        same = same and bits_equal(kernels.bias_grad_bf16(dyv), ref)
    torch.cuda.synchronize()
    axes = tuple(range(len(shape) - 1))
    out = {"shape": list(shape), "exact": same, "ok": same,
           "max_abs_err": float((got - ref).abs().max()),
           "passes": len(kernels.xla_bias_sum_plan(
               ((1, 1) + tuple(shape[:1])) if len(shape) == 2
               else shape[:3]))}
    # read dy, write the f32 sums; one add per element
    out["bound_ms"], out["bound_by"] = bound(2 * n + 4 * c, n, bw, flops)
    out["ms"] = cuda_time_ms(lambda i: kernels.bias_grad_bf16(dy), 10)
    # the plain version loops over a window's elements (up to 32^3
    # launches): one timed call
    out["plain_ms"] = cuda_time_ms(
        lambda i: kernels.bias_grad_bf16_plain(dy), 1, warmup=0)
    out["library_ms"] = cuda_time_ms(lambda i: torch.sum(dy, axes), 10)
    kernels.restore_launch_counts(counts0)
    del dy
    torch.cuda.empty_cache()
    return out


def bias_grad_section(bw: float, flops: float, cfg=None,
                      batch: int = TRAIN_BATCH,
                      expected: int = KAIMING_BF16_LAUNCHES["bias_grad_bf16"]):
    """The bias gradient at every bias of a bf16 training step
    (kaiming-224's at batch 128 unless ``cfg`` names another net),
    weighted by how often each shape occurs."""
    from cxxnet_tpu_torch.nnet.net import FuncNet
    if cfg is None:
        cfg = kaiming_cfg_bf16(TRAIN_BATCH)
    knet = FuncNet(_configured(cfg), batch)
    shapes = path_bias_shapes(knet, batch)
    if len(shapes) != expected:
        raise RuntimeError("expected %d biases, the net has %d"
                           % (expected, len(shapes)))
    cases = {sh: bias_grad_case(sh, bw, flops)
             for sh in sorted(set(shapes), key=lambda v: -int(np.prod(v)))}
    counts = [shapes.count(sh) for sh in cases]
    vals = list(cases.values())
    return {"ok": all(c["ok"] for c in vals),
            "launches_per_step": len(shapes),
            "step_sum": _step_of(vals, ("ms", "plain_ms", "library_ms",
                                        "bound_ms"), counts),
            "max_abs_err": max(c["max_abs_err"] for c in vals),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in vals) else "operations",
            "library": "torch.sum over all but the channel (f32 "
                       "accumulation, one rounding: not the reference's "
                       "bits)",
            "cases": [dict(c, count=k) for c, k in zip(vals, counts)]}


def phase_kernels(bw: float, flops: float, tc_flops: float):
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
    # the int32 accumulator of serve_dtype = int8 and the bf16 path of
    # serve_dtype = bfloat16, at every served shape; plus ragged C and
    # int32 -> bf16
    i32 = torch.int32
    lowp = {}
    for name, in_dt, out_dt in (("int32", i32, f32), ("bf16", bf16, bf16)):
        cs = {sh: epilogue_case(sh, in_dt, out_dt, True, bw, flops)
              for sh in per_shape}
        lowp[name] = {
            "ok": all(c["ok"] for c in cs.values()),
            "forward_sum": {k: sum(cs[sh][k] for sh in shapes)
                            for k in ("ms", "plain_ms", "bound_ms",
                                      "bytes")},
            "max_abs_err": max(c["max_abs_err"] for c in cs.values()),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in cs.values())
            else "operations",
            "path_cases": [dict(c, count=shapes.count(tuple(c["shape"])))
                           for c in cs.values()]}
    int32_extra = [epilogue_case((MAX_BATCH, 28, 28, 67), i32, f32, True,
                                 bw, flops),
                   epilogue_case(stem, i32, bf16, True, bw, flops),
                   epilogue_case(stem, i32, f32, False, bw, flops)]
    lowp["int32"]["extra_cases"] = int32_extra
    lowp["int32"]["exact"] = all(c["exact"] for c in
                                 lowp["int32"]["path_cases"] + int32_extra)
    lowp["int32"]["ok"] = lowp["int32"]["ok"] and all(
        c["ok"] for c in int32_extra)
    lowp["int32"]["max_abs_err"] = max(
        [lowp["int32"]["max_abs_err"]] + [c["max_abs_err"]
                                          for c in int32_extra])
    bwd = epilogue_bwd_case(stem, bw, flops)
    ok = ok and lowp["int32"]["ok"] and lowp["bf16"]["ok"] and bwd["ok"]
    # the training steps' kernels, at their shapes (batch 128), in
    # float32 and in bf16
    train = training_kernel_section(bw, flops, tc_flops, bf16=False)
    train_bf16 = training_kernel_section(bw, flops, tc_flops, bf16=True)
    ok = ok and train["ok"] and train_bf16["ok"]
    # the pool_concat slice: the tower's fused concats in both dtypes,
    # conv_epilogue's bf16 VJP at the stem shape, and kaiming's bf16
    # bias gradients
    pc = {dt: pool_concat_section(bw, flops, dt)
          for dt in ("float32", "bfloat16")}
    bwd_bf16 = [epilogue_bwd_bf16_case(stem, xd, yd, bw, flops)
                for xd, yd in (("bfloat16", "bfloat16"),
                               ("float32", "bfloat16"),
                               ("bfloat16", "float32"))]
    bias = bias_grad_section(bw, flops)
    # the layer-zoo slice: AlexNet.conf's 8 biases at its batch 256
    bias_alex = bias_grad_section(bw, flops, alexnet_cfg(ALEX_BATCH),
                                  ALEX_BATCH, ALEX_LAUNCHES["bias_grad_bf16"])
    ok = ok and all(v["ok"] for v in pc.values()) \
        and all(c["ok"] for c in bwd_bf16) and bias["ok"] \
        and bias_alex["ok"]
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
           "int32": lowp["int32"], "bf16": lowp["bf16"],
           "backward": bwd,
           "bn_apply": train["bn_apply"], "matmul": train["matmul"],
           "relu_max_pool": train["relu_max_pool"],
           "train_bf16": train_bf16, "pool_concat": pc,
           "backward_bf16": bwd_bf16, "bias_grad_bf16": bias,
           "bias_grad_bf16_alexnet": bias_alex}
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


def profile_forward(t, data, nodes, reps: int = 3, kinds=None):
    """torch.profiler over ``reps`` eval forwards of a resident batch:
    device time per forward by kernel name (and, with ``kinds``, by
    kind), the device's busy and idle share of the window, and the
    conv_epilogue kernel's device time."""
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
    by_kind = {}
    for name, (ms, cnt) in by_name.items():
        kind = next((k for k, keys in kinds or () if any(
            key in name for key in keys)), "other")
        e = by_kind.setdefault(kind, {"ms": 0.0, "n": 0.0})
        e["ms"] += ms
        e["n"] += cnt / reps
    return {"wall_ms": wall, "device_busy_ms": busy,
            "by_kind": dict(sorted(by_kind.items(),
                                   key=lambda kv: -kv[1]["ms"]))
            if kinds else None,
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


def drive_session(sess, pool, rec):
    """The serving main path: every launch count set to 0, a closed loop
    of 8 clients x 32 requests x 4 rows and one full-bucket burst in 4
    requests, the counts read. Returns the loop's stats, the burst's
    rows, its time, the latency tails, the launch counts and the
    dispatches."""
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.serve import run_closed_loop
    eng = sess.engine
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
    launches = kernels.launch_counts()
    snap = eng.counters_snapshot()
    return {"loop": loop, "burst": burst, "burst_s": burst_s,
            "tails": tail_report(rec.records, t_drive),
            "launches": launches,
            "dispatches": snap["dispatches"] - base["dispatches"]}


def phase_serve(workdir: str):
    import torch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import ServeSession
    cfg = inception_cfg()
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    init = NetTrainer(cfg, device="cuda")
    init.init_model()
    # realistic running stats: the reference's zero init folds to a
    # ~1e5 scale that overflows through 69 layers
    calibrate_bn(init, init.to_device_batch(images(rng, 32)))
    path = os.path.join(workdir, SERVE_SNAPSHOT)
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
        d = drive_session(sess, pool, rec)
        loop, burst, burst_s, tails = (d["loop"], d["burst"], d["burst_s"],
                                       d["tails"])
        launches = d["launches"]["conv_epilogue"]
        dispatches = d["dispatches"]
        first4 = sess.predict(pool[:4])
    finally:
        summary = sess.close()
    failed = loop["error"] + loop["busy"] + loop["timeout"] \
        + summary["errors"] + summary["timeouts"] + summary["rejected"]
    finite = bool(np.all(np.isfinite(burst)) and np.all(np.isfinite(first4)))
    row_sums = np.concatenate([burst.sum(1), first4.sum(1)])
    sums_ok = bool(np.all(np.abs(row_sums - 1.0) < 1e-4))
    per_forward = len(eng.trainer.net.fold_pairs)
    counted = launches_ok(d["launches"], SERVE_LAUNCHES, dispatches) \
        and per_forward == SERVE_LAUNCHES["conv_epilogue"]

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
           "launches": d["launches"], "expected_per_forward": SERVE_LAUNCHES,
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

# kernel-name substrings -> the kind of work of a quantized forward
_SERVE_KINDS = (("conv_epilogue kernel", ("epilogue_",)),
                ("int8 products (cuBLASLt)", ("gemm", "Gemm", "imma",
                                              "xmma", "cutlass", "sm90",
                                              "sm80", "s8")),
                ("quantize passes (divide, round, clamp)",
                 ("Div", "round", "clamp", "Clamp")),
                ("copies (im2col, pads, int8 casts, staging)",
                 ("copy", "Copy", "Fill", "fill", "pad", "Memcpy",
                  "Memset")),
                ("pooling", ("pool",)),
                ("concat", ("Cat", "cat_")),
                ("convolutions (cuDNN)", ("conv", "implicit", "cudnn",
                                          "fft", "winograd",
                                          "nhwcToNchw", "nchwToNhwc")),
                ("elementwise (avg-pool adds, softmax, bias)",
                 ("softmax", "elementwise", "vectorized", "reduce")))


def rows_vs_cpu(got, ref, atol, rtol):
    """The card's softmax rows against the CPU's: max error, whether
    every entry is within ``atol + rtol * |ref|``, and top-1 agreement
    on every row whose two largest CPU entries lie further apart than
    the tolerance (the others may swap by rounding alone)."""
    tol = atol + rtol * np.abs(ref)
    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * tol.max(axis=1)
    same = got.argmax(1) == ref.argmax(1)
    return {"max_abs_err": float(np.abs(got - ref).max()),
            "max_rel_err": float((np.abs(got - ref) / np.maximum(
                np.abs(ref), np.finfo(np.float32).tiny)).max()),
            "close": bool(np.all(np.abs(got - ref) <= tol)),
            "atol": atol, "rtol": rtol,
            "top1_same": same.tolist(), "top1_decided": decided.tolist(),
            "top1_ok": bool(np.all(same | ~decided))}


def launches_ok(launches, expected, forwards: int) -> bool:
    """Every launch counter at ``forwards`` times its expected count per
    forward."""
    return forwards > 0 and all(launches[k] == n * forwards
                                for k, n in expected.items())


def phase_serve_lowp(workdir: str, kres):
    """serve_dtype = int8 (and bfloat16) on the serve phase's snapshot:
    calibration, the parity gate, the int8 snapshot, its serving main
    path, and a bf16 bucket-128 forward."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.quantize import Calibrator
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import ServeSession
    cfg = inception_cfg()
    f32_path = os.path.join(workdir, SERVE_SNAPSHOT)
    q_path = os.path.join(workdir, "inception_bn_224.int8.model.npz")
    rng = np.random.RandomState(SEED + 8)

    # 1-3. calibrate on seeded batches, gate against the float32 rows,
    # write the int8 snapshot (the reference's task = quantize sequence)
    t0 = time.perf_counter()
    t = NetTrainer(cfg, device=DEVICE)
    t.load_model(f32_path)
    top = (t.graph.num_nodes - 1,)
    cal = Calibrator(t)
    batches = [images(rng, MAX_BATCH) for _ in range(CALIB_BATCHES)]
    refs = []
    for x in batches:
        refs.append(t.pred(t.to_device_batch(x), top)[0].cpu().numpy())
        cal.observe(DataBatch(x))
    tables = cal.finish()
    calib_s = time.perf_counter() - t0
    counts0 = kernels.launch_counts()
    dev_batch = t.to_device_batch(batches[0])
    f32_ms = cuda_time_ms(lambda i: t.pred(dev_batch, top), 10)
    t.set_quantization(tables, {"dtype": "int8", "batches": len(batches),
                                "bn_fold_eval": t.net.bn_fold_eval,
                                "parity_eps": GATE_EPS}, dtype="int8")
    diffs, agree = [], 0
    for x, ref in zip(batches, refs):
        got = t.pred(t.to_device_batch(x), top)[0].cpu().numpy()
        diffs.append(np.abs(got.astype(np.float64) - ref))
        agree += int(np.sum(got.argmax(1) == ref.argmax(1)))
    gate = {"batches": len(batches), "layers": t.quant_report["layers"],
            "native": t.quant_report["native"], "calib_s": calib_s,
            "mean_abs": float(np.mean(diffs)),
            "max_abs": float(np.max(diffs)), "eps": GATE_EPS,
            "top1_agree": agree / (len(batches) * MAX_BATCH),
            "f32_max_prob_mean": float(np.mean([r.max(1) for r in refs]))}
    gate["ok"] = gate["mean_abs"] <= GATE_EPS
    kernels.restore_launch_counts(counts0)
    if not gate["ok"]:
        raise RuntimeError("parity gate failed: %s" % gate)
    t.save_model(q_path)
    del t, refs, diffs
    torch.cuda.empty_cache()

    # 4-5. the int8 snapshot served: the main path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = Recorder()
    sess = ServeSession(cfg + [("serve_dtype", "int8")], model_path=q_path,
                        device=DEVICE, monitor=rec)
    open_s = time.perf_counter() - t0
    eng = sess.engine
    pool = images(rng, 2 * MAX_BATCH)
    try:
        d = drive_session(sess, pool, rec)
        first4 = sess.predict(pool[:4])
    finally:
        summary = sess.close()
    peak = torch.cuda.max_memory_allocated()
    loop, burst = d["loop"], d["burst"]
    failed = loop["error"] + loop["busy"] + loop["timeout"] \
        + summary["errors"] + summary["timeouts"] + summary["rejected"]
    finite = bool(np.all(np.isfinite(burst)) and np.all(np.isfinite(first4)))
    counted = launches_ok(d["launches"], INT8_LAUNCHES, d["dispatches"])

    # the bucket-128 forward by CUDA events beside the float32 one, and
    # a profiled forward
    t = eng.trainer
    launches_before = kernels.launch_counts()
    dev_batch = t.to_device_batch(pool[:MAX_BATCH])
    int8_ms = cuda_time_ms(lambda i: t.pred(dev_batch, eng.nodes), 10)
    prof = profile_forward(t, dev_batch, eng.nodes, kinds=_SERVE_KINDS)
    prof["epilogue_bound_ms"] = kres["int32"]["forward_sum"]["bound_ms"]
    kernels.restore_launch_counts(launches_before)
    del dev_batch

    # 7. 4 rows against the port on the CPU from the same snapshot, and
    # the int8 weights each froze (the fold, then the quantization)
    cpu = NetTrainer(cfg + [("serve_dtype", "int8")], device="cpu")
    cpu.load_model(q_path)
    cpu_int8 = rows_vs_cpu(first4, cpu.extract_feature(
        DataBatch(pool[:4]), "top"), INT8_CPU_ATOL, 0.0)
    ctree, gtree = cpu.freeze_serve_weights(), t.freeze_serve_weights()
    wq = [(gtree[lk]["_wq"].cpu(), sub["_wq"]) for lk, sub in ctree.items()
          if "_wq" in sub]
    cpu_int8["int8_weights"] = sum(int(c.numel()) for _, c in wq)
    cpu_int8["int8_weights_differing"] = sum(int((g != c).sum())
                                             for g, c in wq)
    del cpu, ctree, wq

    # 8. serve_dtype = bfloat16: one bucket-128 forward through a session,
    # then the 4 rows against the CPU's
    bsess = ServeSession(cfg + [("serve_dtype", "bfloat16")],
                         model_path=f32_path, device=DEVICE)
    try:
        kernels.reset_launch_counts()
        b128 = bsess.predict(pool[:MAX_BATCH])
        b_launches = kernels.launch_counts()
        b4 = bsess.predict(pool[:4])
        bt = bsess.engine.trainer
        xb = bt.to_device_batch(pool[:MAX_BATCH]).to(torch.bfloat16)
        bf16_ms = cuda_time_ms(lambda i: bt.pred(xb, bsess.engine.nodes),
                               10)
        bprof = profile_forward(bt, xb, bsess.engine.nodes,
                                kinds=_SERVE_KINDS)
        bprof["epilogue_bound_ms"] = kres["bf16"]["forward_sum"]["bound_ms"]
        del xb
    finally:
        bsess.close()
    kernels.restore_launch_counts(b_launches)
    cpu = NetTrainer(cfg + [("serve_dtype", "bfloat16")], device="cpu")
    cpu.load_model(f32_path)
    cpu_bf16 = rows_vs_cpu(b4, cpu.extract_feature(DataBatch(pool[:4]),
                                                   "top"),
                           BF16_CPU_ATOL, BF16_CPU_RTOL)
    del cpu
    bf16 = {"launches": b_launches, "expected": BF16_LAUNCHES,
            "counted": launches_ok(b_launches, BF16_LAUNCHES, 1),
            "finite": bool(np.all(np.isfinite(b128))),
            "fwd128_ms": bf16_ms, "img_per_s": MAX_BATCH / bf16_ms * 1e3,
            "profile": bprof, "cpu": cpu_bf16}

    res = {"phase": "serve_lowp", "model": "inception_bn_224",
           "serve_dtype": "int8", "buckets": BUCKETS, "gate": gate,
           "open_s": open_s, "closed_loop": loop,
           "burst_rows": int(burst.shape[0]), "burst_s": d["burst_s"],
           "summary": summary, "tails": d["tails"],
           "failed_requests": failed, "dispatches": d["dispatches"],
           "launches": d["launches"], "expected_per_forward": INT8_LAUNCHES,
           "counted": counted,
           "rows_per_sec": loop["rows_per_sec"],
           "p50_ms": summary["latency_p50_ms"],
           "p99_ms": summary["latency_p99_ms"],
           "fwd128_ms_int8": int8_ms, "fwd128_ms_f32": f32_ms,
           "img_per_s_int8": MAX_BATCH / int8_ms * 1e3,
           "img_per_s_f32": MAX_BATCH / f32_ms * 1e3,
           "peak_mem_gb": peak / 1e9, "profile": prof,
           "cpu": cpu_int8, "finite": finite, "bf16": bf16}
    res["ok"] = bool(failed == 0 and finite and counted
                     and cpu_int8["close"] and cpu_int8["top1_ok"]
                     and cpu_int8["int8_weights_differing"] == 0
                     and bf16["counted"] and bf16["finite"]
                     and cpu_bf16["close"] and cpu_bf16["top1_ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("serve_lowp phase failed")
    return res


# ------------------------------------------------------------- phase 5

# kernel-name substrings -> the kind of work a training step spends on
_KINDS = (("host-to-device copies", ("Memcpy HtoD",)),
          ("bn_apply kernels", ("cxn_bn_",)),
          ("matmul kernel", ("cxn_sgemm",)),
          ("relu_max_pool kernels", ("cxn_relu_max_pool",)),
          ("pool_concat kernels", ("cxn_pool_concat",)),
          ("bias_grad_bf16 kernel", ("cxn_bias_window",)),
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
                   "relu_pool_bwd_device_ms": "cxn_relu_max_pool_bwd",
                   "bias_grad_device_ms": "cxn_bias_window"}
TOWER_DEVICE_KEYS = dict(BN_DEVICE_KEYS,
                         pool_concat_fwd_device_ms="cxn_pool_concat_fwd",
                         pool_concat_bwd_device_ms="cxn_pool_concat_bwd")


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


def update_distances(runs, pairs):
    """For runs mapping a name to (per-parameter update, ...): the
    parameter keys, per (a, b) of ``pairs`` the list of ||d_a - d_b|| /
    ||d_b|| over the keys, and the same over the whole update."""
    keys = list(runs[pairs[0][1]][0])

    def rel(a, b, k):
        nb = float(runs[b][0][k].norm())
        return float((runs[a][0][k] - runs[b][0][k]).norm()) / max(nb, 1e-30)

    def whole(a, b):
        num = sum(float((runs[a][0][k] - runs[b][0][k]).norm()) ** 2
                  for k in keys)
        den = sum(float(runs[b][0][k].norm()) ** 2 for k in keys)
        return (num / max(den, 1e-60)) ** 0.5

    names = ["%s_vs_%s" % p for p in pairs]
    return (keys, {n: [rel(a, b, k) for k in keys]
                   for n, (a, b) in zip(names, pairs)},
            {n: whole(a, b) for n, (a, b) in zip(names, pairs)})


def update_delta_check(workdir: str, cfg=None, plain_cfg=None,
                       same_masks: bool = False, tag: str = "train4",
                       batch=None):
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
    and the CPU drop the same units. The plain runs also take every
    kernel entry point through :func:`plain_kernels` (pool_concat's: no
    plain config reaches its function).

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
    if batch is None:
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
        swapped = plain_kernels() if plain else contextlib.nullcontext()
        try:
            with swapped:
                if f64:
                    # update() ships the batch as float32; the same step
                    # on a float64 copy of it
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

    # (run, reference): the held pairs first, then the reported ones
    held = (("gpu_f64", "cpu_f64"), ("gpu", "gpu_plain"))
    pairs = held + (("gpu", "cpu"), ("cpu", "cpu_f64"), ("gpu", "cpu_f64"),
                    ("gpu_no_cudnn", "cpu_f64"))
    keys, table, whole = update_distances(runs, pairs)
    failed = sorted({"%s/%s" % keys[i] for a, b in held
                     for i, r in enumerate(table["%s_vs_%s" % (a, b)])
                     if not r <= UPDATE_RTOL})
    loss = {k: v[1] for k, v in runs.items()}
    loss_ok = all(abs(loss[k] - loss["cpu"]) <= LOSS_RTOL * abs(loss["cpu"])
                  for k in loss)
    out = {"params": len(keys), "losses": loss, "loss_ok": loss_ok,
           "rtol": UPDATE_RTOL, "held": ["%s_vs_%s" % p for p in held],
           "whole": whole,
           "worst": {name: max(v) for name, v in table.items()},
           "failed": failed,
           # [param, then one column per pair in the order of "whole"]
           "rows": [["%s/%s" % k] + [table[n][i] for n in table]
                    for i, k in enumerate(keys)]}
    out["ok"] = bool(loss_ok and not failed)
    return out


@contextlib.contextmanager
def plain_kernels():
    """The training kernels' autograd entry points (``bn_apply``,
    ``matmul``, ``relu_max_pool``, ``pool_concat``, ``bias_add``, as the
    layers call them) swapped for autograd Functions over their plain
    versions, with the kernels' VJP arithmetic: the card's plain path of
    the same function, which the wrappers themselves never take on a
    CUDA tensor."""
    import torch
    from cxxnet_tpu_torch.layers import common, conv
    from cxxnet_tpu_torch.layers import kernels as K

    class PlainBnApply(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, scale, shift, relu):
            y = K.bn_apply_plain(x, scale, shift, relu)
            ctx.relu = relu
            ctx.save_for_backward(x, scale, y)
            return y

        @staticmethod
        def backward(ctx, dy):
            x, scale, y = ctx.saved_tensors
            return K.bn_apply_bwd_plain(x, y, dy, scale, ctx.relu) + (None,)

    class PlainMatmul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return K.matmul_plain(x, w)

        @staticmethod
        def backward(ctx, dy):
            x, w = ctx.saved_tensors
            return (K.matmul_plain(dy, w.t()).to(x.dtype),
                    K.matmul_plain(x.t(), dy).to(w.dtype))

    class PlainReluMaxPool(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, k):
            x = x.contiguous()
            y = K.relu_max_pool_plain(x, k)
            ctx.k = k
            ctx.save_for_backward(x, y)
            return y

        @staticmethod
        def backward(ctx, dy):
            x, y = ctx.saved_tensors
            return K.relu_max_pool_bwd_plain(x, y, dy, ctx.k), None

    class PlainPoolConcat(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pos, k, mode, *branches):
            out = K.pool_concat_plain(branches, pos, k, mode)
            ctx.args = (pos, k, mode, [x.shape[3] for x in branches],
                        [x.dtype for x in branches])
            ctx.save_for_backward(branches[pos], out)
            return out

        @staticmethod
        def backward(ctx, dy):
            x, out = ctx.saved_tensors
            pos, k, mode, widths, dtypes = ctx.args
            grads, off = [], 0
            for i, (c, dt) in enumerate(zip(widths, dtypes)):
                grads.append(K.pool_concat_bwd_plain(x, out, dy, off, k, mode)
                             if i == pos else dy[..., off:off + c].to(dt))
                off += c
            return (None, None, None, *grads)

    class PlainBiasAdd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, bias):
            ctx.dtype = bias.dtype
            return y + bias.to(torch.bfloat16)

        @staticmethod
        def backward(ctx, dy):
            return dy, K.bias_grad_bf16_plain(dy).to(ctx.dtype)

    def bias_add(y, bias):
        if y.dtype == torch.bfloat16:
            return PlainBiasAdd.apply(y, bias)
        return y + bias.to(y.dtype)

    swaps = ((conv, "bn_apply", lambda x, s, t, relu=False:
              PlainBnApply.apply(x, s, t, bool(relu))),
             (common, "matmul", PlainMatmul.apply),
             (conv, "relu_max_pool", lambda x, k:
              PlainReluMaxPool.apply(x, int(k))),
             (common, "pool_concat", lambda bs, pos, k, mode:
              PlainPoolConcat.apply(int(pos), int(k), mode, *bs)),
             (common, "bias_add", bias_add), (conv, "bias_add", bias_add))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bf16_update_check(workdir: str, cfg, expected, tag: str,
                      same_masks: bool = False, batch=None):
    """One update at batch 4 at a bf16 training config, from one seeded
    snapshot and batch, on the card through the kernels and through
    their plain versions (:func:`plain_kernels`), with cuDNN
    deterministic; and, to show what a change of summation order alone
    does to a bf16 update, the plain path with cuDNN off (im2col and
    cuBLAS products), reported, not held. Per parameter
    ||d_a - d_b|| / ||d_b|| with d = w_after - w_before. Held: the loss
    within LOSS_RTOL, the whole update within BF16_UPDATE_RTOL (reason
    there) and within BF16_ORDER_SHARE of the cuDNN-off distance, the
    kernels' launches ``expected``, none on the plain path."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import common, kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    init = NetTrainer(cfg, device=DEVICE)
    init.init_model()
    path = os.path.join(workdir, "%s.model.npz" % tag)
    init.save_model(path)
    del init
    if batch is None:
        rng = np.random.RandomState(SEED + 4)
        batch = DataBatch(images(rng, 4),
                          rng.randint(0, NCLASS, (4, 1)).astype(np.float32))

    def delta(plain: bool, cudnn: bool = True):
        t = NetTrainer(cfg, device=DEVICE)
        t.load_model(path)
        w0 = {(lk, tg): w.detach().cpu().clone()
              for lk, sub in t.params.items() for tg, w in sub.items()}
        before = kernels.launch_counts()
        cudnn_was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn
        try:
            with plain_kernels() if plain else contextlib.nullcontext():
                t.update(batch)
        finally:
            torch.backends.cudnn.enabled = cudnn_was
        after = kernels.launch_counts()
        kernels.restore_launch_counts(before)
        return ({k: t.params[k[0]][k[1]].detach().cpu().double()
                 - w0[k].double() for k in w0}, t.last_loss,
                {k: after[k] - before[k] for k in after})

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    uniform = common.dropout_uniform
    if same_masks:
        common.dropout_uniform = seeded_uniform
    try:
        runs = {"kernels": delta(False), "plain": delta(True),
                "plain_no_cudnn": delta(True, cudnn=False)}
    finally:
        torch.backends.cudnn.deterministic = det
        common.dropout_uniform = uniform
    keys, table, whole = update_distances(
        runs, (("kernels", "plain"), ("plain_no_cudnn", "plain")))
    loss = {k: v[1] for k, v in runs.items()}
    identical = sum(bool(torch.equal(runs["kernels"][0][k],
                                     runs["plain"][0][k])) for k in keys)
    out = {"params": len(keys), "losses": loss,
           "loss_rel": abs(loss["kernels"] - loss["plain"])
           / abs(loss["plain"]),
           "bit_identical_params": identical,
           "bit_for_bit": identical == len(keys),
           "rtol": BF16_UPDATE_RTOL, "order_share": BF16_ORDER_SHARE,
           "held": "kernels_vs_plain (whole), against rtol and against "
                   "order_share * plain_no_cudnn_vs_plain",
           "whole": whole,
           "worst": {n: max(v) for n, v in table.items()},
           "worst_param": {n: "%s/%s" % keys[int(np.argmax(v))]
                           for n, v in table.items()},
           "median": {n: float(np.median(v)) for n, v in table.items()},
           "launches": {"kernels": runs["kernels"][2],
                        "plain": runs["plain"][2]},
           "expected_launches": expected}
    out["ok"] = bool(out["loss_rel"] <= LOSS_RTOL
                     and whole["kernels_vs_plain"] <= BF16_UPDATE_RTOL
                     and whole["kernels_vs_plain"] <= BF16_ORDER_SHARE
                     * whole["plain_no_cudnn_vs_plain"]
                     and runs["kernels"][2] == expected
                     and all(v == 0 for v in runs["plain"][2].values()))
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
    # the drive times the update alone: no train metrics (the cli phase
    # collects them, as the CLI does by default)
    t = NetTrainer(list(cfg) + [("eval_train", "0")], device=DEVICE)
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


# ------------------------------------------------------------- phase 6


def phase_train_bf16(workdir: str, f32_step_ms: float):
    """Inception-BN-224 at the bench set (``dtype = grad_dtype =
    momentum_dtype = bfloat16``), batch 128: the training drive, exactly
    69 + 69 bf16 bn_apply and 3 bf16 matmul launches per step and no
    float32 one, then the batch-4 update through the kernels against
    the card's bf16 plain path."""
    import torch
    t, res = drive_train(train_cfg_bf16(TRAIN_BATCH), TRAIN_BF16_LAUNCHES,
                         BN_DEVICE_KEYS)
    del t
    torch.cuda.empty_cache()
    delta = bf16_update_check(workdir, train_cfg_bf16(4),
                              TRAIN_BF16_LAUNCHES, "train4_bf16")
    res = dict({"phase": "train_bf16", "model": "inception_bn_224",
                "config": "pallas_fullc fc1, bn_pallas, bn_fuse_relu, "
                          "dtype = grad_dtype = momentum_dtype = "
                          "bfloat16, sgd momentum 0.9"}, **res)
    res.update(f32_step_ms=f32_step_ms, update_vs_plain=delta)
    res["ok"] = bool(res["counted"] and res["loss_falls"] and delta["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("train_bf16 phase failed")
    return res


# ------------------------------------------------------------- phase 7


def phase_train_kaiming(workdir: str):
    import torch
    t, res = drive_train(kaiming_cfg(TRAIN_BATCH), KAIMING_LAUNCHES,
                         RMP_DEVICE_KEYS)
    delta = update_delta_check(workdir, kaiming_cfg(4), kaiming_cfg(4, 0),
                               same_masks=True, tag="kaiming4")
    pools = pool_backward_check(t.net)
    del t
    torch.cuda.empty_cache()
    # the same path at bench.py's kaiming set: relu_max_pool in bf16
    tb, bres = drive_train(kaiming_cfg_bf16(TRAIN_BATCH),
                           KAIMING_BF16_LAUNCHES, RMP_DEVICE_KEYS)
    del tb
    torch.cuda.empty_cache()
    bdelta = bf16_update_check(workdir, kaiming_cfg_bf16(4),
                               KAIMING_BF16_LAUNCHES, "kaiming4_bf16",
                               same_masks=True)
    bres = dict({"config": "fused_pools, pallas_pool = 1, dropout 0.5, "
                           "dtype = momentum_dtype = bfloat16"}, **bres)
    bres.update(update_vs_plain=bdelta)
    res = dict({"phase": "train_kaiming", "model": "kaiming_224",
                "config": "fused_pools, pallas_pool = 1, dropout 0.5, "
                          "f32, TF32 off, sgd momentum 0.9"}, **res)
    res.update(update_vs_cpu=delta, pool_backward_vs_cpu=pools, bf16=bres)
    res["ok"] = bool(res["counted"] and res["loss_falls"] and delta["ok"]
                     and all(p["ok"] for p in pools) and bres["counted"]
                     and bres["loss_falls"] and bdelta["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("train_kaiming phase failed")
    return res


# ------------------------------------------------------------- phase 8

# the Inception tower of the pool_concat slice: Inception-BN-224's stem,
# then modules at Inception-BN's widths with the pool projections
# dropped, so that each stride-1 module's pool feeds its concat directly
# (the pass-through branch of the _inception helper, proj 0):
# (name, 1x1, 3x3 reduce, 3x3, double-3x3 reduce, double-3x3, pool,
# proj, stride)
TOWER_MODULES = (("t3a", 64, 64, 64, 64, 96, "avg", 0, 1),     # i3a's
                 ("t3b", 64, 64, 96, 64, 96, "max", 0, 1),     # i3b's
                 ("t3c", 0, 128, 160, 64, 96, "max", 0, 2),    # i3c
                 ("t4a", 224, 64, 96, 96, 128, "max", 0, 1))   # i4a's
# the reference's planner fuses these concats (its 6 MiB gate refuses
# t3b's 30 x 30 x 768 x 4 B map at f32, admits it at 2 B; t3c's pool
# has stride 2)
TOWER_FUSED = {"float32": ("t3a", "t4a"),
               "bfloat16": ("t3a", "t3b", "t4a")}
TOWER_KNOBS = [("pool_concat_pallas", "1")]


def tower_text(batch: int, image_size: int = 224, nclass: int = NCLASS,
               helpers=None) -> str:
    """The tower's netconfig: ``inception_bn()``'s stem, TOWER_MODULES
    through the ``_inception`` helper of ``helpers`` (a module with
    ``_conv_bn_relu`` and ``_inception``; the port's models.inception by
    default, so that a test can build the same text with the
    reference's), then a global avg pool, flatten, ``fullc:fc1`` and
    softmax; inception_bn()'s training keys. 26 conv and 26 batch_norm
    layers."""
    if helpers is None:
        from cxxnet_tpu_torch.models import inception as helpers
    L = ["netconfig=start"]
    helpers._conv_bn_relu(L, "0", "c1", "conv1", 64, 7, 2, 3)
    L += ["layer[c1->p1] = max_pooling", "  kernel_size = 3",
          "  stride = 2"]
    helpers._conv_bn_relu(L, "p1", "c2r", "conv2red", 64, 1)
    helpers._conv_bn_relu(L, "c2r", "c2", "conv2", 192, 3, 1, 1)
    L += ["layer[c2->p2] = max_pooling", "  kernel_size = 3",
          "  stride = 2"]
    top = "p2"
    for (nm, n1, n3r, n3, nd3r, nd3, pool, np_, st) in TOWER_MODULES:
        top = helpers._inception(L, top, nm, n1, n3r, n3, nd3r, nd3, pool,
                                 np_, st)
    L += ["layer[%s->gap] = avg_pooling" % top,
          "  kernel_size = %d" % (image_size // 16), "  stride = 1",
          "layer[gap->flat] = flatten",
          "layer[flat->fc] = fullc:fc1",
          "  nhidden = %d" % nclass,
          "  init_sigma = 0.01",
          "layer[fc->fc] = softmax",
          "netconfig=end",
          "input_shape = 3,%d,%d" % (image_size, image_size),
          "batch_size = %d" % batch,
          "momentum = 0.9",
          "wmat:lr = 0.01",
          "wmat:wd = 0.0001",
          "bias:lr = 0.02",
          "bias:wd = 0.000",
          "random_type = xavier",
          "metric = error"]
    return "\n".join(L) + "\n"


def tower_train_cfg(batch: int):
    """The tower as the training slices run it (phase 5's keys: fc1 as
    ``pallas_fullc``, ``bn_pallas = bn_fuse_relu = 1``) with
    ``pool_concat_pallas = 1``."""
    from cxxnet_tpu_torch.utils.config import parse_config
    text = tower_text(batch).replace("fullc:fc1", "pallas_fullc:fc1")
    return parse_config(text) + TRAIN_KNOBS + TOWER_KNOBS + [
        ("seed", str(SEED))]


def tower_train_cfg_bf16(batch: int):
    """The tower at the bench set (``dtype = grad_dtype = momentum_dtype
    = bfloat16``): the gate admits t3b's concat too."""
    return tower_train_cfg(batch) + BENCH_BF16


def phase_tower(workdir: str):
    """The pool_concat slice through its entry points: the tower trained
    at f32 and at the bench set, and served at f32 (see the module
    docstring)."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import ServeSession
    # f32 training: the drive, the float64 batch-4 update check
    t, tr = drive_train(tower_train_cfg(TRAIN_BATCH), TOWER_LAUNCHES,
                        TOWER_DEVICE_KEYS)
    fused = sorted(t.net.fused_concats.values())
    del t
    torch.cuda.empty_cache()
    # the plain runs keep the concats fused and take pool_concat's plain
    # version: unfused, the max pools' backward would credit one tied
    # maximum, not every one (another function; at initialization relu
    # zeros tie in whole windows)
    cfg4 = tower_train_cfg(4)
    tr["update_vs_cpu"] = update_delta_check(
        workdir, cfg4, inception_plain_cfg(cfg4), tag="tower4")
    tr["fused"] = fused
    tr["ok"] = bool(tr["counted"] and tr["loss_falls"]
                    and tr["update_vs_cpu"]["ok"])
    # bench-set training: the drive, the batch-4 check against the card's
    # bf16 plain path
    tb, br = drive_train(tower_train_cfg_bf16(TRAIN_BATCH),
                         TOWER_BF16_LAUNCHES, TOWER_DEVICE_KEYS)
    br["fused"] = sorted(tb.net.fused_concats.values())
    del tb
    torch.cuda.empty_cache()
    br["update_vs_plain"] = bf16_update_check(
        workdir, tower_train_cfg_bf16(4), TOWER_BF16_LAUNCHES, "tower4_bf16")
    br["ok"] = bool(br["counted"] and br["loss_falls"]
                    and br["update_vs_plain"]["ok"])
    # f32 serving from a snapshot of the tower
    cfg = tower_serve_cfg()
    rng = np.random.RandomState(SEED + 8)
    init = NetTrainer(cfg, device=DEVICE)
    init.init_model()
    calibrate_bn(init, init.to_device_batch(images(rng, 32)))
    path = os.path.join(workdir, "tower_224.model.npz")
    init.save_model(path)
    del init
    rec = Recorder()
    sess = ServeSession(cfg, model_path=path, device=DEVICE, monitor=rec)
    pool = images(rng, 2 * MAX_BATCH)
    try:
        d = drive_session(sess, pool, rec)
        first4 = sess.predict(pool[:4])
        eng = sess.engine
        t = eng.trainer
        dev_batch = t.to_device_batch(pool[:MAX_BATCH])
        counts = kernels.launch_counts()
        fwd_ms = cuda_time_ms(lambda i: t.pred(dev_batch, eng.nodes), 10)
        kernels.restore_launch_counts(counts)
    finally:
        summary = sess.close()
    loop = d["loop"]
    failed = loop["error"] + loop["busy"] + loop["timeout"] \
        + summary["errors"] + summary["timeouts"] + summary["rejected"]
    from cxxnet_tpu_torch.io import DataBatch
    cpu = NetTrainer(cfg, device="cpu")
    cpu.load_model(path)
    ref4 = cpu.extract_feature(DataBatch(pool[:4]), "top")
    kernels.restore_launch_counts(counts)
    finite = bool(np.all(np.isfinite(d["burst"]))
                  and np.all(np.isfinite(first4)))
    sr = {"failed_requests": failed, "dispatches": d["dispatches"],
          "launches": d["launches"],
          "expected_per_forward": TOWER_SERVE_LAUNCHES,
          "closed_loop": loop, "burst_rows": int(d["burst"].shape[0]),
          "burst_s": d["burst_s"], "tails": d["tails"],
          "fwd128_ms": fwd_ms, "img_per_s": MAX_BATCH / fwd_ms * 1e3,
          "cpu": rows_vs_cpu(first4, ref4, SERVE_ATOL, SERVE_RTOL),
          "finite": finite,
          "fused": sorted(cpu.net.fused_concats.values())}
    sr["ok"] = bool(failed == 0 and finite and sr["cpu"]["close"]
                    and sr["cpu"]["top1_ok"]
                    and launches_ok(d["launches"], TOWER_SERVE_LAUNCHES,
                                    d["dispatches"]))
    res = {"phase": "tower", "model": "inception_tower_224",
           "config": "inception_bn()'s stem, modules t3a (avg), t3b (max), "
                     "t3c (stride 2), t4a (max) without pool projections, "
                     "pool_concat_pallas = 1",
           "train": dict(tr, config="pallas_fullc fc1, bn_pallas, "
                         "bn_fuse_relu, f32, TF32 off, sgd momentum 0.9"),
           "train_bf16": dict(br, config="the same at dtype = grad_dtype = "
                              "momentum_dtype = bfloat16",
                              f32_step_ms=tr["step_ms"]),
           "serve": dict(sr, config="bn_fold_eval, bn_fuse_relu, "
                         "conv_pallas_epilogue, f32")}
    res["ok"] = bool(tr["ok"] and br["ok"] and sr["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("tower phase failed")
    return res


def tower_serve_cfg():
    """The tower as phase 3 serves Inception-BN (``bn_fold_eval =
    bn_fuse_relu = conv_pallas_epilogue = 1``) with ``pool_concat_pallas
    = 1``."""
    from cxxnet_tpu_torch.utils.config import parse_config
    return parse_config(tower_text(MAX_BATCH)) + KNOBS + TOWER_KNOBS + [
        ("seed", str(SEED)), ("serve_buckets", BUCKETS),
        ("serve_max_delay_ms", "2")]


# ------------------------------------------------------------- phase 9

# the cli phase: Inception-BN.conf's data from seeded raw-tensor imgrec
# archives (256x256x3 uint8, labels in 0-999): 2 full batches of 128 and a
# 44-row tail that round_batch wraps, and a validation archive
CLI_IMAGE = 256
CLI_TRAIN_RECORDS, CLI_VAL_RECORDS = 300, 200
CLI_ROUNDS = 2
# per update of Inception-BN.conf through the CLI (dtype = bfloat16 alone,
# bn_pallas = bn_fuse_relu = 1): every batch norm through bf16 bn_apply,
# and fc1, a plain fullc whose bias adds to a bf16 output, sums its bias
# gradient in bf16; the eval forwards of the round lines (moving-average
# batch norm, no fold) launch no kernel
CLI_TRAIN_LAUNCHES = dict(NO_LAUNCHES, bn_apply_fwd_bf16=69,
                          bn_apply_bwd_bf16=69, bias_grad_bf16=1)
# per pred / serve forward under bn_fold_eval = bn_fuse_relu =
# conv_pallas_epilogue = 1, at the conf's dtype = bfloat16
CLI_PRED_LAUNCHES = BF16_LAUNCHES
CLI_SOAK = ["serve_clients=8", "serve_requests=8", "serve_request_rows=4"]
MNIST_GATE = 0.03
_ROUND_LINE = re.compile(r"^\[(\d+)\]((?:\t[\w@-]+:\S+)*)$")
_SERVE_LINE = re.compile(r"^serve: (\d+) ok / (\d+) busy / (\d+) timeout / "
                         r"(\d+) error requests \((\d+) rows\)")


def cli_dev_args():
    """The CLI runs on the card unless the smoke runs on the CPU (a
    rehearsal)."""
    return [] if DEVICE == "cuda" else ["dev=" + DEVICE]


def write_cli_archives(workdir: str,
                       specs=(("train.rec", CLI_TRAIN_RECORDS),
                              ("val.rec", CLI_VAL_RECORDS))):
    """Seeded raw-tensor imgrec archives (decoded with numpy alone), one
    per (file name, records) of ``specs``."""
    from cxxnet_tpu_torch.io import recordio
    rng = np.random.RandomState(SEED + 9)
    paths = []
    for name, n in specs:
        path = os.path.join(workdir, name)
        w = recordio.RecordIOWriter(path)
        for i in range(n):
            img = rng.randint(0, 256, (CLI_IMAGE, CLI_IMAGE, 3),
                              dtype=np.uint8)
            w.write_record(recordio.pack_raw_tensor_record(
                i, float(rng.randint(NCLASS)), img))
        w.close()
        paths.append(path)
    return paths


def shipped_conf(workdir: str, name: str, train_rec: str,
                 val_rec: str) -> str:
    """A copy of example/ImageNet/<name> with only its data paths
    pointed at the archives."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "example", "ImageNet", name)) as f:
        text = f.read()
    for rec, path in (("train.rec", train_rec), ("val.rec", val_rec)):
        old = "path_imgrec = %s\n" % rec
        assert text.count(old) == 1, old
        text = text.replace(old, "path_imgrec = %s\n" % path)
    path = os.path.join(workdir, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def run_cli(argv, cwd=None):
    """One in-process ``LearnTask().run(argv)``: (rc, stdout lines)."""
    import io
    from cxxnet_tpu_torch.main import LearnTask
    buf = io.StringIO()
    old = os.getcwd()
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            rc = LearnTask().run(list(argv) + cli_dev_args())
    finally:
        os.chdir(old)
    return rc, buf.getvalue().splitlines()


@contextlib.contextmanager
def tap_trainer(rec):
    """Record, for every ``NetTrainer`` the CLI builds, each update's
    launch counts (counter deltas), loss, wall time (to a device sync)
    and rows, each eval forward's launch counts, and each closed round's
    throughput; the methods are restored on exit."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    names = ("update", "update_many", "pred", "end_round")
    orig = {n: getattr(NetTrainer, n) for n in names}
    for key in ("updates", "forwards", "rounds"):
        rec.setdefault(key, [])

    def delta(before):
        after = kernels.launch_counts()
        return {k: after[k] - before[k] for k in after}

    def stepped(fn):
        def run(self, arg):
            batches = list(arg) if isinstance(arg, (list, tuple)) \
                else [arg]
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            fn(self, arg)
            loss = self.last_loss            # waits for the device
            torch.cuda.synchronize()
            rec["updates"].append({
                "batches": len(batches), "launches": delta(before),
                "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                "rows": sum(b.batch_size - b.num_batch_padd
                            for b in batches)})
        return run

    def pred(self, data, nodes, mask=None):
        before = kernels.launch_counts()
        out = orig["pred"](self, data, nodes, mask)
        rec["forwards"].append(delta(before))
        return out

    def end_round(self):
        was_open = self._round_t0 is not None
        orig["end_round"](self)
        if was_open:
            rec["rounds"].append({
                "round": self.round, "examples": self.last_round_examples,
                "wall_s": self.last_round_wall_s,
                "rows_per_s": self.last_round_examples_per_sec})

    NetTrainer.update = stepped(orig["update"])
    NetTrainer.update_many = stepped(orig["update_many"])
    NetTrainer.pred = pred
    NetTrainer.end_round = end_round
    try:
        yield rec
    finally:
        for n in names:
            setattr(NetTrainer, n, orig[n])


def round_lines(lines):
    """{round: {metric: value}} of the CLI's ``[r]\t<name>-<metric>:v``
    lines."""
    out = {}
    for ln in lines:
        m = _ROUND_LINE.match(ln)
        if m:
            out[int(m.group(1))] = {
                k: float(v) for k, v in
                (t.rsplit(":", 1) for t in m.group(2).split("\t") if t)}
    return out


def serve_line(lines):
    for ln in lines:
        m = _SERVE_LINE.match(ln)
        if m:
            ok, busy, timeout, error, rows = (int(g) for g in m.groups())
            return {"ok": ok, "failed": busy + timeout + error,
                    "rows": rows, "line": ln}
    return None


def cli_mnist(workdir: str, here: str):
    """``python -m cxxnet_tpu_torch.main example/MNIST/MNIST.conf`` as a
    subprocess from a directory whose data/ links the tracked idx files;
    each output line is stamped on arrival, so a round's time is the gap
    between two round lines (its training pass and its test pass)."""
    d = os.path.join(workdir, "mnist")
    os.makedirs(d)
    os.symlink(os.path.join(here, "example", "MNIST", "data"),
               os.path.join(d, "data"))
    mdir = os.path.join(d, "models")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH", "")) if p))
    cmd = [sys.executable, "-m", "cxxnet_tpu_torch.main",
           os.path.join(here, "example", "MNIST", "MNIST.conf"),
           "model_dir=" + mdir, "save_model=15"] + cli_dev_args()
    lines, stamps = [], []
    t0 = time.perf_counter()
    with open(os.path.join(d, "stderr.txt"), "w") as err:
        p = subprocess.Popen(cmd, cwd=d, env=env, stdout=subprocess.PIPE,
                             stderr=err, text=True)
        try:
            for ln in p.stdout:
                lines.append(ln.rstrip("\n"))
                stamps.append(time.perf_counter() - t0)
            rc = p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    with open(os.path.join(d, "stderr.txt")) as f:
        tail = f.read()[-2000:]
    rounds = round_lines(lines)
    at = {int(_ROUND_LINE.match(ln).group(1)): t
          for ln, t in zip(lines, stamps) if _ROUND_LINE.match(ln)}
    ntrain = 24000
    per_round = [{"round": r, "s": at[r] - at[r - 1],
                  "train_rows_per_s": ntrain / (at[r] - at[r - 1])}
                 for r in sorted(at) if r - 1 in at]
    errs = [v.get("test-error", 1.0) for _, v in sorted(rounds.items())]
    snap = os.path.join(mdir, "0015.model.npz")
    res = {"rc": rc, "wall_s": wall_s, "rounds": len(rounds),
           "test_error": errs, "best_test_error": min(errs) if errs else None,
           "first_round_s": at.get(1), "per_round": per_round,
           "snapshot": os.path.exists(snap),
           "stderr_tail": tail if rc else ""}
    res["ok"] = bool(rc == 0 and len(rounds) == 15 and errs
                     and min(errs) < MNIST_GATE and res["snapshot"])
    # quantize that snapshot (calibration on the train block's
    # deterministic fallback) and serve it at int8
    conf = os.path.join(here, "example", "MNIST", "MNIST.conf")
    qout = os.path.join(mdir, "0015.model.int8.npz")
    rc_q, qlines = run_cli([conf, "task=quantize", "model_in=" + snap],
                           cwd=d)
    qline = next((ln for ln in qlines if ln.startswith("quantize[")), "")
    m = re.search(r"parity mean\|Δ\| (\S+) max\|Δ\| (\S+) agree (\S+)",
                  qline)
    q = {"rc": rc_q, "line": qline, "written": os.path.exists(qout)}
    if m:
        q.update(mean_abs=float(m.group(1)), max_abs=float(m.group(2)),
                 agree=float(m.group(3)))
    q["ok"] = bool(rc_q == 0 and m and q["mean_abs"] <= GATE_EPS
                   and q["written"])
    rc_s, slines = run_cli([conf, "task=serve", "serve_dtype=int8",
                            "model_in=" + qout] + CLI_SOAK, cwd=d)
    sv = serve_line(slines) or {}
    sv["rc"] = rc_s
    sv["ok"] = bool(rc_s == 0 and sv.get("failed") == 0
                    and sv.get("ok") == 64)
    res.update(quantize=q, serve_int8=sv)
    return res


def phase_cli(workdir: str):
    """The CLI slice through its entry point (see the module docstring):
    MNIST.conf as a subprocess, then Inception-BN.conf trained, predicted
    and served in process, then the MNIST snapshot quantized and served
    at int8."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch, create_iterator
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import (parse_cli_overrides,
                                               parse_config_file)
    here = os.path.dirname(os.path.abspath(__file__))
    mnist = cli_mnist(workdir, here)
    t0 = time.perf_counter()
    train_rec, val_rec = write_cli_archives(workdir)
    archives_s = time.perf_counter() - t0
    conf = shipped_conf(workdir, "Inception-BN.conf", train_rec, val_rec)
    mdir = os.path.join(workdir, "inception")
    runs = {}

    def drive(name, argv):
        rec = {}
        kernels.reset_launch_counts()            # the main path: from 0
        t1 = time.perf_counter()
        with tap_trainer(rec):
            rc, lines = run_cli(argv)
        rec.update(rc=rc, lines=lines, wall_s=time.perf_counter() - t1,
                   launches=kernels.launch_counts())
        runs[name] = rec
        return rec

    # train: the conf's own batch 128, 224 crop, 1000 classes and dtype
    tr = drive("train", [conf, "task=train", "bn_pallas=1",
                         "bn_fuse_relu=1", "num_round=%d" % CLI_ROUNDS,
                         "print_step=1", "model_dir=" + mdir])
    snap = os.path.join(mdir, "%04d.model.npz" % CLI_ROUNDS)
    ups = tr["updates"]
    per_round = -(-CLI_TRAIN_RECORDS // TRAIN_BATCH)
    evals = CLI_ROUNDS * -(-CLI_VAL_RECORDS // TRAIN_BATCH)
    losses = [u["loss"] for u in ups]
    step_ms = [u["ms"] for u in ups]
    lines = round_lines(tr["lines"])
    # a round's window (start_round to end_round) less its updates: the
    # time the loop waited on the iterator (decode and augment in the
    # threadbuffer's thread)
    for i, rd in enumerate(tr["rounds"]):
        rd["update_s"] = sum(step_ms[i * per_round:(i + 1) * per_round]) / 1e3
        rd["data_wait_s"] = rd["wall_s"] - rd["update_s"]
    train = {
        "rc": tr["rc"], "wall_s": tr["wall_s"], "archives_s": archives_s,
        "round_lines": lines, "updates": len(ups), "losses": losses,
        "finite": bool(np.all(np.isfinite(losses))),
        "step_ms": step_ms,
        "steady_step_ms": float(np.median(step_ms[1:])) if len(ups) > 1
        else None,
        "rows_per_update": [u["rows"] for u in ups],
        "rounds": tr["rounds"],
        "launches": tr["launches"],
        "launches_per_update": ups[-1]["launches"] if ups else None,
        "expected_per_update": CLI_TRAIN_LAUNCHES,
        "eval_forwards": len(tr["forwards"]),
        "eval_forward_launches": sum(sum(f.values())
                                     for f in tr["forwards"]),
        "snapshot": os.path.exists(snap),
        "progress_lines": sum(ln.startswith("round ")
                              for ln in tr["lines"])}
    train["counted"] = bool(
        len(ups) == CLI_ROUNDS * per_round
        and all(u["batches"] == 1 and u["launches"] == CLI_TRAIN_LAUNCHES
                for u in ups)
        and train["eval_forwards"] == evals
        and train["eval_forward_launches"] == 0
        and all(tr["launches"][k] == n * len(ups)
                for k, n in CLI_TRAIN_LAUNCHES.items()))
    train["ok"] = bool(tr["rc"] == 0 and train["counted"]
                       and train["finite"] and train["snapshot"]
                       and sorted(lines) == list(range(1, CLI_ROUNDS + 1))
                       and all("train-error" in v and "val-error" in v
                               for v in lines.values()))
    # pred / pred_raw / serve from that snapshot over val.rec (a pred
    # block given on the command line), the eval fold on
    knobs = ["%s=%s" % kv for kv in KNOBS]
    block = ["iter=imgrec", "path_imgrec=" + val_rec,
             "input_shape=3,224,224", "mean_value=123,117,104", "iter=end"]
    out = {}
    for task, extra in (("pred", []), ("pred_raw", []),
                        ("extract", ["extract_node_name=flat"])):
        out[task] = os.path.join(workdir, task + ".txt")
        drive(task, [conf, "task=" + task, "model_in=" + snap] + knobs
              + extra + ["pred=" + out[task]] + block)
    cls = np.loadtxt(out["pred"], ndmin=1)
    raw = np.loadtxt(out["pred_raw"], ndmin=2)
    flat = np.loadtxt(out["extract"], ndmin=2)
    with open(out["pred_raw"] + ".meta") as f:
        raw_meta = f.read().strip()
    # the first 4 rows against the port on the CPU: the same snapshot,
    # knobs and records; the eval path runs in bf16 (the conf's dtype)
    cfg = parse_config_file(conf) + parse_cli_overrides(knobs)
    cpu = NetTrainer(cfg, device="cpu")
    cpu.load_model(snap)
    it = create_iterator(parse_cli_overrides(block[:-1]),
                         [("batch_size", "4")])
    it.init()
    try:
        first4 = next(iter(it))
    finally:
        it.close()
    counts = kernels.launch_counts()
    ref4 = cpu.extract_feature(DataBatch(first4.data), "top")
    flat4 = cpu.extract_feature(DataBatch(first4.data), "flat")
    kernels.restore_launch_counts(counts)
    del cpu
    # the pooled features under the rows (a softmax that saturates on the
    # running statistics of 6 updates hides the net's differences): bf16
    # tolerances relative to the features' scale
    scale = float(np.abs(flat4).max())
    flat_err = np.abs(flat[:4] - flat4)
    preds = {
        "pred_rc": runs["pred"]["rc"], "pred_raw_rc": runs["pred_raw"]["rc"],
        "pred_rows": int(cls.shape[0]),
        "pred_classes_ok": bool(np.all((cls >= 0) & (cls < NCLASS))
                                and np.all(cls == np.round(cls))),
        "pred_raw_shape": list(raw.shape), "pred_raw_meta": raw_meta,
        "row_sum_max_err": float(np.abs(raw.sum(1) - 1).max()),
        "pred_is_argmax": bool(np.all(cls == raw.argmax(1))),
        "distinct_classes": int(len(np.unique(cls))),
        "eval_dtype": "bfloat16",
        "cpu": rows_vs_cpu(raw[:4], ref4, BF16_CPU_ATOL, BF16_CPU_RTOL),
        "flat_shape": list(flat.shape),
        "flat_cpu": {"max_abs_err": float(flat_err.max()),
                     "scale": scale,
                     "max_rel_err": float((flat_err / np.maximum(
                         np.abs(flat4), 1e-3 * scale)).max()),
                     "close": bool(np.all(flat_err <= BF16_CPU_RTOL
                                          * np.abs(flat4) + 1e-3 * scale))},
        "forwards": {t: len(runs[t]["forwards"]) for t in out},
        "launches": {t: runs[t]["launches"] for t in out}}
    preds["counted"] = all(
        len(runs[t]["forwards"]) == 2
        and all(f == CLI_PRED_LAUNCHES for f in runs[t]["forwards"])
        for t in out)
    preds["ok"] = bool(
        preds["pred_rc"] == 0 and preds["pred_raw_rc"] == 0
        and preds["pred_rows"] == CLI_VAL_RECORDS
        and preds["pred_classes_ok"]
        and raw.shape == (CLI_VAL_RECORDS, NCLASS)
        and preds["row_sum_max_err"] < 1e-4 and preds["pred_is_argmax"]
        and preds["cpu"]["close"] and preds["cpu"]["top1_ok"]
        and flat.shape == (CLI_VAL_RECORDS, flat4.shape[1])
        and preds["flat_cpu"]["close"] and preds["counted"])
    sr = drive("serve", [conf, "task=serve", "model_in=" + snap] + knobs
               + CLI_SOAK + ["serve_buckets=" + BUCKETS, "pred=serve.txt"]
               + block)
    soak = serve_line(sr["lines"]) or {}
    serve = dict(soak, rc=sr["rc"], wall_s=sr["wall_s"],
                 forwards=len(sr["forwards"]), launches=sr["launches"],
                 expected_per_forward=CLI_PRED_LAUNCHES)
    serve["counted"] = bool(sr["forwards"] and all(
        f == CLI_PRED_LAUNCHES for f in sr["forwards"]))
    serve["ok"] = bool(sr["rc"] == 0 and soak.get("failed") == 0
                       and soak.get("ok") == 64 and serve["counted"])
    torch.cuda.empty_cache()
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in NO_LAUNCHES}
    res = {"phase": "cli", "model": "Inception-BN.conf",
           "config": "example/ImageNet/Inception-BN.conf with its data "
                     "paths on seeded raw-tensor imgrec archives (%dx%dx3, "
                     "%d train / %d val records), batch %d, 224 crop, %d "
                     "classes, dtype = bfloat16; bn_pallas = bn_fuse_relu "
                     "= 1 for train, bn_fold_eval = bn_fuse_relu = "
                     "conv_pallas_epilogue = 1 for pred and serve"
                     % (CLI_IMAGE, CLI_IMAGE, CLI_TRAIN_RECORDS,
                        CLI_VAL_RECORDS, TRAIN_BATCH, NCLASS),
           "mnist": mnist, "train": train, "pred": preds, "serve": serve,
           "launches": total}
    res["ok"] = bool(mnist["ok"] and mnist["quantize"]["ok"]
                     and mnist["serve_int8"]["ok"] and train["ok"]
                     and preds["ok"] and serve["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("cli phase failed")
    return res


# ------------------------------------------------------------ phase 10

# the layer-zoo slice: example/ImageNet/AlexNet.conf through the CLI, its
# data on seeded raw-tensor imgrec archives (256x256x3 uint8, labels in
# 0-999): two full batches of 256 a round, and one validation batch
ALEX_TRAIN_RECORDS, ALEX_VAL_RECORDS = 512, 256
ALEX_BATCH, ALEX_ROUNDS = 256, 2
# per update of AlexNet.conf (dtype = bfloat16 alone): every conv and
# fullc bias (conv1-5, fc6-8) adds to a bf16 output, so its gradient sums
# in bf16 through bias_grad_bf16; no other kernel is on the path, and
# the round lines' eval forwards launch nothing
ALEX_LAUNCHES = dict(NO_LAUNCHES, bias_grad_bf16=8)
# the bias gradient's device time in a profiled AlexNet step (the LRNs'
# elementwise kernels are timed apart, lrn_cost)
ALEX_DEVICE_KEYS = {"bias_grad_device_ms": "cxn_bias_window"}
# the zoo net's update on the card against the CPU's, per parameter
ZOO_BATCH, ZOO_IMAGE = 8, 32


def write_fixconn(path: str, nrow: int, ncol: int, seed: int = SEED) -> str:
    """A seeded fixconn weight file: every third entry of an (nrow, ncol)
    matrix, as ``nrow ncol nnz`` and ``row col value`` lines."""
    rng = np.random.RandomState(seed + 10)
    w = rng.randn(nrow, ncol) / np.sqrt(ncol)
    nz = [(r, c, w[r, c]) for r in range(nrow) for c in range(ncol)
          if (r + c) % 3 == 0]
    with open(path, "w") as f:
        f.write("%d %d %d\n" % (nrow, ncol, len(nz)))
        f.write("\n".join("%d %d %.6f" % t for t in nz) + "\n")
    return path


def zoo_text(batch: int, image: int, fixconn_path: str) -> str:
    """A small net that holds every layer type of the zoo slice:
    batch_norm_no_ma, prelu (with training noise), insanity_max_pooling,
    a pairtest-conv-torch, xelu, sum_pooling, lrn, bias, insanity (its
    bounds annealing from the first step), fixconn, and two loss heads on
    two label fields: multi_logistic on ``tags`` (6 columns of 0 / 1) and
    l2_loss on ``reg`` (4 columns). The conv before the batch norm has
    no bias: the norm removes it, and its gradient would be rounding
    noise that no two devices share."""
    return """label_vec[0,6) = tags
label_vec[6,10) = reg
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
  no_bias = 1
layer[1->2] = batch_norm_no_ma:bn1
layer[2->3] = prelu:pr1
  random = 0.1
layer[3->4] = insanity_max_pooling:ip1
  kernel_size = 2
  stride = 2
  keep = 0.6
layer[4->5] = pairtest-conv-torch:pt1
  kernel_size = 3
  pad = 1
  nchannel = 8
layer[5->6] = xelu:xe1
layer[6->7] = sum_pooling:sp1
  kernel_size = 2
  stride = 2
layer[7->8] = lrn:lrn1
  local_size = 3
  alpha = 0.01
layer[8->9] = flatten:fl1
layer[9->10] = fullc:fc1
  nhidden = 32
layer[10->10] = bias:b1
layer[10->11] = insanity:in1
  lb = 3
  ub = 8
  calm_start = -1
  calm_end = 4
layer[11->12] = fixconn:fx1
  nhidden = 24
  fixconn_weight = %s
layer[12->13] = fullc:fc2
  nhidden = 6
layer[13->13] = multi_logistic:ml1
  target = tags
layer[12->14] = fullc:fc3
  nhidden = 4
layer[14->14] = l2_loss:l2
  target = reg
netconfig=end
input_shape = 3,%d,%d
batch_size = %d
momentum = 0.9
wmat:lr = 0.005
bias:lr = 0.005
random_type = xavier
""" % (fixconn_path, image, image, batch)


def zoo_batch(rng, n: int, image: int = ZOO_IMAGE):
    """Seeded inputs and the zoo net's (n, 10) labels: 6 tag columns of
    0 / 1, then 4 regression targets."""
    from cxxnet_tpu_torch.io import DataBatch
    x = rng.randn(n, image, image, 3).astype(np.float32)
    label = np.hstack([(rng.rand(n, 6) > 0.5), rng.randn(n, 4)]) \
        .astype(np.float32)
    return DataBatch(x, label)


def alexnet_cfg(batch: int):
    """The trainer keys of example/ImageNet/AlexNet.conf (its global
    section: the net, dtype = bfloat16 and its training keys) at
    ``batch``, seeded."""
    from cxxnet_tpu_torch.utils.config import (parse_config_file,
                                               split_sections)
    here = os.path.dirname(os.path.abspath(__file__))
    _, cfg = split_sections(parse_config_file(
        os.path.join(here, "example", "ImageNet", "AlexNet.conf")))
    return cfg + [("batch_size", str(batch)), ("seed", str(SEED))]


def alexnet_batch(rng, n: int):
    """Seeded 227x227 inputs (the conf's crop, mean-subtracted scale) and
    labels in 0-999."""
    from cxxnet_tpu_torch.io import DataBatch
    x = 60 * rng.randn(n, 227, 227, 3).astype(np.float32)
    return DataBatch(x, rng.randint(0, NCLASS, (n, 1)).astype(np.float32))


def lrn_cost(layer, batch: int, bw: float):
    """Device time of one LRN layer's forward and backward at the path's
    shape (bf16, batch ``batch``), from the profiler (every kernel the
    two launch), and its bound at the card's memory rate ``bw``: read x
    and dy, write y and dx (bf16)."""
    import torch
    s = layer.in_shapes[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    x = (20 * torch.randn((batch, s.y, s.x, s.ch), generator=gen,
                          device=DEVICE)).to(torch.bfloat16) \
        .requires_grad_(True)
    dy = torch.randn((batch, s.y, s.x, s.ch), generator=gen,
                     device=DEVICE).to(torch.bfloat16)

    def fwd_bwd(i):
        (y,), _ = layer.forward({}, {}, [x], True)
        torch.autograd.grad(y, [x], dy)

    ms = device_ms({"lrn": (fwd_bwd, "")}, 10)["lrn"]
    n = x.numel()
    return {"shape": [batch, s.y, s.x, s.ch], "device_ms": ms,
            "bound_ms": 4 * 2 * n / bw * 1e3}


def zoo_check(workdir: str):
    """The zoo net (``zoo_text``, every layer type of the slice) at batch
    8, 32 px: one float32 update on the card against the CPU port per
    parameter (``update_delta_check``, the draws of every stochastic
    layer from ``seeded_uniform`` on both devices), then one more card
    update whose pairtest ``max_diff`` and insanity state are reported."""
    import torch
    from cxxnet_tpu_torch.layers import common
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config
    fx = write_fixconn(os.path.join(workdir, "zoo_fixconn.txt"), 24, 32)
    cfg = parse_config(zoo_text(ZOO_BATCH, ZOO_IMAGE, fx)) + [
        ("seed", str(SEED))]
    batch = zoo_batch(np.random.RandomState(SEED + 4), ZOO_BATCH)
    delta = update_delta_check(workdir, cfg, cfg, same_masks=True,
                               tag="zoo", batch=batch)
    t = NetTrainer(cfg, device=DEVICE)
    t.init_model()
    uniform = common.dropout_uniform
    common.dropout_uniform = seeded_uniform
    try:
        t.update(batch)
    finally:
        common.dropout_uniform = uniform
    st = {lk: {k: float(v) for k, v in sub.items() if v.dim() == 0}
          for lk, sub in t.net_state.items()}
    del t
    torch.cuda.empty_cache()
    delta.update(batch=ZOO_BATCH, image=ZOO_IMAGE,
                 layer_types=sorted({ln.split("=")[1].split(":")[0].strip()
                                     for ln in zoo_text(1, 1, fx)
                                     .splitlines()
                                     if ln.startswith("layer[")}),
                 state_after_one_update=st,
                 pairtest_max_diff=st["pt1"]["pairtest:max_diff"])
    return delta


def phase_alexnet(workdir: str, bw: float):
    """The layer-zoo slice (see the module docstring): AlexNet.conf
    through the CLI, trained, predicted and checked; then the zoo net."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch, create_iterator
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import (parse_cli_overrides,
                                               parse_config_file)
    t0 = time.perf_counter()
    train_rec, val_rec = write_cli_archives(
        workdir, (("alex_train.rec", ALEX_TRAIN_RECORDS),
                  ("alex_val.rec", ALEX_VAL_RECORDS)))
    archives_s = time.perf_counter() - t0
    conf = shipped_conf(workdir, "AlexNet.conf", train_rec, val_rec)
    mdir = os.path.join(workdir, "alexnet")
    runs = {}

    def drive(name, argv):
        rec = {}
        kernels.reset_launch_counts()            # the main path: from 0
        t1 = time.perf_counter()
        with tap_trainer(rec):
            rc, lines = run_cli(argv)
        rec.update(rc=rc, lines=lines, wall_s=time.perf_counter() - t1,
                   launches=kernels.launch_counts())
        runs[name] = rec
        return rec

    # train: the conf as shipped (batch 256, 227 crop, 1000 classes,
    # dtype = bfloat16); only the data paths, the rounds and model_dir
    # are set from outside
    tr = drive("train", [conf, "task=train", "num_round=%d" % ALEX_ROUNDS,
                         "print_step=1", "model_dir=" + mdir])
    snap = os.path.join(mdir, "%04d.model.npz" % ALEX_ROUNDS)
    ups = tr["updates"]
    per_round = -(-ALEX_TRAIN_RECORDS // ALEX_BATCH)
    evals = ALEX_ROUNDS * -(-ALEX_VAL_RECORDS // ALEX_BATCH)
    losses = [u["loss"] for u in ups]
    step_ms = [u["ms"] for u in ups]
    lines = round_lines(tr["lines"])
    for i, rd in enumerate(tr["rounds"]):
        rd["update_s"] = sum(step_ms[i * per_round:(i + 1) * per_round]) / 1e3
        rd["data_wait_s"] = rd["wall_s"] - rd["update_s"]
    train = {
        "rc": tr["rc"], "wall_s": tr["wall_s"], "archives_s": archives_s,
        "round_lines": lines, "updates": len(ups), "losses": losses,
        "finite": bool(np.all(np.isfinite(losses))), "step_ms": step_ms,
        "rows_per_update": [u["rows"] for u in ups],
        "rounds": tr["rounds"], "launches": tr["launches"],
        "launches_per_update": [u["launches"] for u in ups],
        "expected_per_update": ALEX_LAUNCHES,
        "eval_forwards": len(tr["forwards"]),
        "eval_forward_launches": sum(sum(f.values())
                                     for f in tr["forwards"]),
        "snapshot": os.path.exists(snap),
        "stdout_tail": tr["lines"][-6:]}
    train["counted"] = bool(
        len(ups) == ALEX_ROUNDS * per_round
        and all(u["batches"] == 1 and u["launches"] == ALEX_LAUNCHES
                for u in ups)
        and train["eval_forwards"] == evals
        and train["eval_forward_launches"] == 0
        and all(tr["launches"][k] == n * len(ups)
                for k, n in ALEX_LAUNCHES.items()))
    train["ok"] = bool(tr["rc"] == 0 and train["counted"]
                       and train["finite"] and train["snapshot"]
                       and sorted(lines) == list(range(1, ALEX_ROUNDS + 1))
                       and all("train-error" in v and "val-error" in v
                               for v in lines.values()))
    # one step of the conf's net at its batch, profiled (a seeded
    # trainer from the same keys), and the LRNs' own device time
    t = NetTrainer(alexnet_cfg(ALEX_BATCH) + [("eval_train", "0")],
                   device=DEVICE)
    t.init_model()
    b = alexnet_batch(np.random.RandomState(SEED + 13), ALEX_BATCH)
    t.update(b)
    prof = profile_step(t, b, reps=3, device_keys=ALEX_DEVICE_KEYS)
    lrns = [lrn_cost(t.net.layer_objs[li], ALEX_BATCH, bw)
            for li, info in enumerate(t.net.graph.layers)
            if info.type == "lrn"]
    lrn_ms = sum(c["device_ms"] for c in lrns)
    prof.update(lrn=lrns, lrn_device_ms=lrn_ms,
                lrn_share_of_busy=lrn_ms / prof["device_busy_ms"])
    del t
    torch.cuda.empty_cache()
    # pred / pred_raw / extract (fc7's features, node top[-1]) over the
    # val archive from the round-2 snapshot (a pred block on the command
    # line); the first 4 rows against the port on the CPU
    block = ["iter=imgrec", "path_imgrec=" + val_rec,
             "input_shape=3,227,227", "mean_value=123,117,104", "iter=end"]
    out = {}
    for task, extra in (("pred", []), ("pred_raw", []),
                        ("extract", ["extract_node_name=top[-1]"])):
        out[task] = os.path.join(workdir, "alex_%s.txt" % task)
        drive(task, [conf, "task=" + task, "model_in=" + snap] + extra
              + ["pred=" + out[task]] + block)
    cls = np.loadtxt(out["pred"], ndmin=1)
    raw = np.loadtxt(out["pred_raw"], ndmin=2)
    feat = np.loadtxt(out["extract"], ndmin=2)
    cpu = NetTrainer(parse_config_file(conf), device="cpu")
    cpu.load_model(snap)
    it = create_iterator(parse_cli_overrides(block[:-1]),
                         [("batch_size", "4")])
    it.init()
    try:
        first4 = next(iter(it))
    finally:
        it.close()
    counts = kernels.launch_counts()
    ref4 = cpu.extract_feature(DataBatch(first4.data), "top")
    feat4 = cpu.extract_feature(DataBatch(first4.data), "top[-1]")
    kernels.restore_launch_counts(counts)
    del cpu
    scale = float(np.abs(feat4).max())
    ferr = np.abs(feat[:4] - feat4)
    preds = {
        "rcs": {k: runs[k]["rc"] for k in out},
        "pred_rows": int(cls.shape[0]),
        "pred_classes_ok": bool(np.all((cls >= 0) & (cls < NCLASS))
                                and np.all(cls == np.round(cls))),
        "pred_raw_shape": list(raw.shape),
        "pred_is_argmax": bool(np.all(cls == raw.argmax(1))),
        "distinct_classes": int(len(np.unique(cls))),
        "eval_dtype": "bfloat16",
        "cpu": rows_vs_cpu(raw[:4], ref4, BF16_CPU_ATOL, BF16_CPU_RTOL),
        "fc7_cpu": {"max_abs_err": float(ferr.max()), "scale": scale,
                    "close": bool(np.all(ferr <= BF16_CPU_RTOL
                                         * np.abs(feat4) + 1e-3 * scale))},
        "forwards": {k: len(runs[k]["forwards"]) for k in out},
        "launches": {k: runs[k]["launches"] for k in out}}
    preds["counted"] = all(
        len(runs[k]["forwards"]) == 1
        and all(sum(f.values()) == 0 for f in runs[k]["forwards"])
        for k in out)
    preds["ok"] = bool(
        all(rc == 0 for rc in preds["rcs"].values())
        and preds["pred_rows"] == ALEX_VAL_RECORDS
        and preds["pred_classes_ok"] and preds["pred_is_argmax"]
        and raw.shape == (ALEX_VAL_RECORDS, NCLASS)
        and preds["cpu"]["close"] and preds["cpu"]["top1_ok"]
        and feat.shape == (ALEX_VAL_RECORDS, 4096)
        and preds["fc7_cpu"]["close"] and preds["counted"])
    # one batch-4 bf16 update through the kernel against the card's plain
    # path (the same dropout masks on both)
    bdelta = bf16_update_check(
        workdir, alexnet_cfg(4), ALEX_LAUNCHES, "alexnet4", same_masks=True,
        batch=alexnet_batch(np.random.RandomState(SEED + 4), 4))
    zoo = zoo_check(workdir)
    res = {"phase": "alexnet", "model": "AlexNet.conf",
           "config": "example/ImageNet/AlexNet.conf with its data paths on "
                     "seeded raw-tensor imgrec archives (%dx%dx3, %d train / "
                     "%d val records), batch %d, 227 crop, %d classes, "
                     "dtype = bfloat16, %d rounds"
                     % (CLI_IMAGE, CLI_IMAGE, ALEX_TRAIN_RECORDS,
                        ALEX_VAL_RECORDS, ALEX_BATCH, NCLASS, ALEX_ROUNDS),
           "train": train, "profile": prof, "pred": preds,
           "update_vs_plain": bdelta, "zoo": zoo,
           "launches": runs["train"]["launches"]}
    res["ok"] = bool(train["ok"] and preds["ok"] and bdelta["ok"]
                     and zoo["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("alexnet phase failed")
    return res


def kernels_line(kres, sres, lres, tres, tbres, kmres, twres, part: str):
    """The ``kernels`` record: every ported kernel (and bf16
    instantiation) with its launches on its path's run, its error
    against its plain version, its times on the card and its bound, at
    the path's shapes."""
    fwd = kres["forward_sum"]
    i32, b16, bwd = kres["int32"], kres["bf16"], kres["backward"]
    per_fwd = "one forward at bucket 128: %d launches" \
        % kres["path_launches_per_forward"]
    bn, mm, rmp = kres["bn_apply"], kres["matmul"], kres["relu_max_pool"]
    prof, kprof = tres["profile"], kmres["profile"]
    kb = kres["train_bf16"]
    bb, bm, br = kb["bn_apply"], kb["matmul"], kb["relu_max_pool"]
    bprof, kbprof = tbres["profile"], kmres["bf16"]["profile"]
    per_bstep = "one bench-set (bf16) training step at batch %d: %%d " \
        "launches" % TRAIN_BATCH
    per_step = "one training step at batch %d" % TRAIN_BATCH
    per_kstep = "one kaiming-224 training step at batch %d: %d launches" \
        % (TRAIN_BATCH, rmp["launches_per_step"])
    pc, pcb = kres["pool_concat"]["float32"], kres["pool_concat"]["bfloat16"]
    twt, twb = twres["train"], twres["train_bf16"]
    per_tstep = "one Inception-tower training step at batch %d: %%d " \
        "launches" % TRAIN_BATCH
    bias = kres["bias_grad_bf16"]
    ebf = kres["backward_bf16"]
    main_runs = (sres["launches"], lres["launches"],
                 lres["bf16"]["launches"], tres["launches"],
                 tbres["launches"], kmres["launches"],
                 kmres["bf16"]["launches"], twt["launches"],
                 twb["launches"], twres["serve"]["launches"])
    pool_rows = []
    for rec, sec, run, sfx in ((PC_FWD, pc, twt, "fwd"),
                               (PC_BWD, pc, twt, "bwd"),
                               (PC_FWD_BF16, pcb, twb, "fwd"),
                               (PC_BWD_BF16, pcb, twb, "bwd")):
        pool_rows.append(dict(
            rec, launches=run["launches"][rec["name"]],
            max_abs_err=sec["%s_max_abs_err" % sfx],
            ms=sec["step_sum"]["%s_ms" % sfx],
            plain_ms=sec["step_sum"]["%s_plain_ms" % sfx],
            bound_ms=sec["step_sum"]["%s_bound_ms" % sfx],
            bound_by=sec["%s_bound_by" % sfx], library_ms=None,
            reference_ms=sec["step_sum"]["reference_%s_ms" % sfx],
            reference=sec["reference"],
            device_ms=run["profile"]["pool_concat_%s_device_ms" % sfx],
            per=per_tstep % sec["launches_per_step"]
            + (" (dtype = bfloat16)" if sec is pcb else ""), peaks=part))
    return {"kernels": pool_rows + [
        dict(EPILOGUE_BWD_BF16,
             launches=sum(r["conv_epilogue_bwd_bf16"] for r in main_runs),
             max_abs_err=max(c["dx_err"] for c in ebf),
             ms=ebf[0]["ms"], plain_ms=ebf[0]["plain_ms"],
             bound_ms=ebf[0]["bound_ms"], bound_by=ebf[0]["bound_by"],
             library_ms=None,
             sum_max_rel_err=max(c["sum_rel"] for c in ebf),
             by_dtypes=[{k: c[k] for k in ("x", "y", "ms", "device_ms",
                                            "plain_ms", "bound_ms",
                                            "sum_rel")} for c in ebf],
             kernel_device_ms=ebf[0]["device_ms"],
             per="one backward at the stem shape %s, x and y bf16 (the "
             "f32 / bf16 pairs under by_dtypes); launches: its count over "
             "the ten main-path runs, none of which differentiates it"
             % ebf[0]["shape"], peaks=part),
        dict(BIAS_BF16, launches=kmres["bf16"]["launches"]["bias_grad_bf16"],
             max_abs_err=bias["max_abs_err"], ms=bias["step_sum"]["ms"],
             plain_ms=bias["step_sum"]["plain_ms"],
             bound_ms=bias["step_sum"]["bound_ms"],
             bound_by=bias["bound_by"],
             library_ms=bias["step_sum"]["library_ms"],
             library=bias["library"],
             device_ms=kbprof["bias_grad_device_ms"],
             per="one kaiming-224 training step at batch %d, dtype = "
             "bfloat16: %d launches" % (TRAIN_BATCH,
                                        bias["launches_per_step"]),
             peaks=part),
        dict(EPILOGUE, launches=sres["conv_epilogue_launches"],
             max_abs_err=kres["max_abs_err"], ms=fwd["ms"],
             plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
             bound_by=kres["bound_by"], library_ms=None,
             device_ms=sres["profile"]["epilogue_device_ms"],
             per=per_fwd, peaks=part),
        dict(EPILOGUE_INT32,
             launches=lres["launches"]["conv_epilogue_int32"],
             max_abs_err=i32["max_abs_err"], ms=i32["forward_sum"]["ms"],
             plain_ms=i32["forward_sum"]["plain_ms"],
             bound_ms=i32["forward_sum"]["bound_ms"],
             bound_by=i32["bound_by"], library_ms=None,
             device_ms=lres["profile"]["epilogue_device_ms"],
             per=per_fwd + " (serve_dtype = int8)", peaks=part),
        dict(EPILOGUE_BF16,
             launches=lres["bf16"]["launches"]["conv_epilogue_bf16"],
             max_abs_err=b16["max_abs_err"], ms=b16["forward_sum"]["ms"],
             plain_ms=b16["forward_sum"]["plain_ms"],
             bound_ms=b16["forward_sum"]["bound_ms"],
             bound_by=b16["bound_by"], library_ms=None,
             device_ms=lres["bf16"]["profile"]["epilogue_device_ms"],
             per=per_fwd + " (serve_dtype = bfloat16)", peaks=part),
        dict(EPILOGUE_BWD, launches=sum(
            r["conv_epilogue_bwd"] for r in main_runs),
             max_abs_err=bwd["dx_err"],
             ms=bwd["ms"], plain_ms=bwd["plain_ms"],
             bound_ms=bwd["bound_ms"], bound_by=bwd["bound_by"],
             library_ms=None, sum_max_rel_err=bwd["sum_rel"],
             kernel_device_ms=bwd["device_ms"],
             per="one backward at the stem shape %s; launches: its "
             "count over the ten main-path runs (serve f32, int8, bf16, "
             "train, train_bf16, train_kaiming f32 and bf16, tower train "
             "f32 and bf16, tower serve), none of which differentiates "
             "it" % bwd["shape"], peaks=part),
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
             kernel_device_ms=bn["step_sum"]["bwd_device_ms"],
             sum_max_rel_err=bn["bwd_sum_max_rel"],
             per="%s: %d launches" % (per_step, bn["launches_per_step"]),
             peaks=part),
        dict(MATMUL, launches=tres["launches"]["matmul"],
             max_abs_err=mm["max_abs_err"], ms=mm["step_sum"]["ms"],
             plain_ms=mm["step_sum"]["plain_ms"],
             bound_ms=mm["step_sum"]["bound_ms"], bound_by=mm["bound_by"],
             library_ms=mm["step_sum"]["library_ms"],
             device_ms=prof["matmul_device_ms"],
             kernel_device_ms=mm["step_sum"]["device_ms"],
             library_device_ms=mm["step_sum"]["library_device_ms"],
             routes=mm["routes"], max_rel_err=mm["max_rel_err"],
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
             device_ms=kprof["relu_pool_fwd_device_ms"],
             kernel_device_ms=rmp["kernel_section_ms"]["fwd"],
             routes=[r[0] for r in rmp["routes"]], per=per_kstep,
             peaks=part),
        dict(RMP_BWD, launches=kmres["launches"]["relu_max_pool_bwd"],
             max_abs_err=rmp["bwd_max_abs_err"],
             ms=rmp["step_sum"]["bwd_ms"],
             plain_ms=rmp["step_sum"]["bwd_plain_ms"],
             bound_ms=rmp["step_sum"]["bwd_bound_ms"],
             bound_by=rmp["bwd_bound_by"], library_ms=None,
             reference_ms=rmp["step_sum"]["reference_bwd_ms"],
             reference=rmp["reference"],
             device_ms=kprof["relu_pool_bwd_device_ms"],
             kernel_device_ms=rmp["kernel_section_ms"]["bwd"],
             routes=[r[1:] for r in rmp["routes"]], per=per_kstep,
             peaks=part),
        dict(BN_FWD_BF16, launches=tbres["launches"]["bn_apply_fwd_bf16"],
             max_abs_err=bb["fwd_max_abs_err"], ms=bb["step_sum"]["fwd_ms"],
             plain_ms=bb["step_sum"]["fwd_plain_ms"],
             bound_ms=bb["step_sum"]["fwd_bound_ms"],
             bound_by=bb["fwd_bound_by"], library_ms=None,
             device_ms=bprof["bn_fwd_device_ms"],
             per=per_bstep % bb["launches_per_step"], peaks=part),
        dict(BN_BWD_BF16, launches=tbres["launches"]["bn_apply_bwd_bf16"],
             max_abs_err=bb["bwd_max_abs_err"], ms=bb["step_sum"]["bwd_ms"],
             plain_ms=bb["step_sum"]["bwd_plain_ms"],
             bound_ms=bb["step_sum"]["bwd_bound_ms"],
             bound_by=bb["bwd_bound_by"], library_ms=None,
             device_ms=bprof["bn_bwd_device_ms"],
             kernel_device_ms=bb["step_sum"]["bwd_device_ms"],
             sum_max_rel_err=bb["bwd_sum_max_rel"],
             per=per_bstep % bb["launches_per_step"], peaks=part),
        dict(MATMUL_BF16, launches=tbres["launches"]["matmul_bf16"],
             max_abs_err=bm["max_abs_err"], ms=bm["step_sum"]["ms"],
             plain_ms=bm["step_sum"]["plain_ms"],
             bound_ms=bm["step_sum"]["bound_ms"], bound_by=bm["bound_by"],
             library_ms=bm["step_sum"]["library_ms"],
             library_fwd_ms=bm["path_cases"][0]["library_ms"],
             library=[c["library"] for c in bm["path_cases"]],
             library_missing=bm["path_cases"][0].get("library_missing"),
             device_ms=bprof["matmul_device_ms"],
             kernel_device_ms=bm["step_sum"]["device_ms"],
             kernel_fwd_device_ms=bm["path_cases"][0]["device_ms"],
             library_fwd_device_ms=bm["path_cases"][0]["library_device_ms"],
             routes=bm["routes"], max_rel_err=bm["max_rel_err"],
             per=(per_bstep % bm["launches_per_step"])
             + " (bf16 . bf16, f32 . bf16, bf16 . f32)", peaks=part),
        dict(RMP_FWD_BF16,
             launches=kmres["bf16"]["launches"]["relu_max_pool_fwd_bf16"],
             max_abs_err=br["fwd_max_abs_err"],
             ms=br["step_sum"]["fwd_ms"],
             plain_ms=br["step_sum"]["fwd_plain_ms"],
             bound_ms=br["step_sum"]["fwd_bound_ms"],
             bound_by=br["fwd_bound_by"], library_ms=None,
             reference_ms=br["step_sum"]["reference_fwd_ms"],
             reference=br["reference"],
             device_ms=kbprof["relu_pool_fwd_device_ms"],
             kernel_device_ms=br["kernel_section_ms"]["fwd"],
             routes=[r[0] for r in br["routes"]],
             per=per_kstep + " (dtype = bfloat16)", peaks=part),
        dict(RMP_BWD_BF16,
             launches=kmres["bf16"]["launches"]["relu_max_pool_bwd_bf16"],
             max_abs_err=br["bwd_max_abs_err"],
             ms=br["step_sum"]["bwd_ms"],
             plain_ms=br["step_sum"]["bwd_plain_ms"],
             bound_ms=br["step_sum"]["bwd_bound_ms"],
             bound_by=br["bwd_bound_by"], library_ms=None,
             reference_ms=br["step_sum"]["reference_bwd_ms"],
             reference=br["reference"],
             device_ms=kbprof["relu_pool_bwd_device_ms"],
             kernel_device_ms=br["kernel_section_ms"]["bwd"],
             routes=[r[1:] for r in br["routes"]],
             per=per_kstep + " (dtype = bfloat16)", peaks=part)]}


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
        kres = phase_kernels(bw, flops, bf16_tc_peak(part))
        phase = "serve"
        sres = phase_serve(workdir)
        phase = "serve_lowp"
        lres = phase_serve_lowp(workdir, kres)
        phase = "train"
        tres = phase_train(workdir)
        phase = "train_bf16"
        tbres = phase_train_bf16(workdir, tres["step_ms"])
        phase = "train_kaiming"
        kmres = phase_train_kaiming(workdir)
        phase = "tower"
        twres = phase_tower(workdir)
        phase = "cli"
        clires = phase_cli(workdir)
        phase = "alexnet"
        alexres = phase_alexnet(workdir, bw)
    except Exception as e:
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": "%s: %s" % (type(e).__name__, e)})
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kl = kernels_line(kres, sres, lres, tres, tbres, kmres, twres, part)
    for row in kl["kernels"]:
        # the cli phase's runs (train, pred, pred_raw, serve), each with
        # the counts set to 0 just before it, and the alexnet phase's
        # training run
        row["cli_launches"] = clires["launches"][row["name"]]
        row["alexnet_launches"] = alexres["launches"][row["name"]]
        if row["name"] == BIAS_BF16["name"]:
            ab = kres["bias_grad_bf16_alexnet"]
            row["alexnet"] = {
                "per": "one AlexNet.conf update at batch %d: %d launches"
                       % (ALEX_BATCH, ab["launches_per_step"]),
                "max_abs_err": ab["max_abs_err"],
                "ms": ab["step_sum"]["ms"],
                "plain_ms": ab["step_sum"]["plain_ms"],
                "bound_ms": ab["step_sum"]["bound_ms"],
                "bound_by": ab["bound_by"],
                "library_ms": ab["step_sum"]["library_ms"],
                "device_ms": alexres["profile"]["bias_grad_device_ms"],
                "cases": [{k: c[k] for k in ("shape", "count", "ms",
                                             "plain_ms", "bound_ms",
                                             "library_ms", "exact")}
                          for c in ab["cases"]]}
    emit(kl)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
