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
             8 (batch 256), the same bits, each pass's route and channel
             group printed (``kernels.bias_grad_plan``), with the chain
             floor (``chain_bound_ms``: the plan's longest-window adds
             times one dependent add's latency, which ``bf16_add_probe``
             measures with a one-warp chain of ``add.rn.bf16x2`` after
             holding that add to PyTorch's f32-add-then-round on
             ``bf16_edge_classes``: the same bits) beside the bytes
             bound; and at edge-class cotangents (subnormal and
             signed-zero sums; inf, NaN and overflowing sums), an odd C,
             C = 100, fullc shapes (one of three passes) and a
             misaligned cotangent, the same bits. pool_concat's forward
             also from channel slices whose bases are off 16 bytes and
             from branches of both dtypes (the pool branch of either),
             each launch's routes printed (``kernels.pool_concat_plan``:
             the tower's concats take 16-byte vectors); the backward's
             plan (``kernels.pool_concat_bwd_plan``: route, tile, staged
             bytes) and profiled device time beside the forward's, also
             at maps smaller than a tile, a partial last channel job
             and border ties with the pad's zero, both modes. Max
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
             the batch-4 check against the card's bf16 plain path); each
             drive prints the route of every pool_concat backward launch
             of one more update and fails unless all take 16-byte
             vectors; then
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
             pointed at seeded raw-tensor imgrec archives (768 train and
             200 val records of 256x256x3 uint8, labels in 0-999): 2
             rounds of 6 batches at the conf's batch 128, 224 crop, 1000
             classes and ``dtype = bfloat16`` with ``bn_pallas =
             bn_fuse_relu = 1``, every batch staged on the card in the
             prefetch thread from the pinned ring (the round lines, every
             update's loss finite, 0002.model.npz written, exactly 69 +
             69 bf16 bn_apply and 1 bias_grad_bf16 launches per update
             and none in the round lines' eval forwards, each update's
             time, each round's rows/s, ``data_wait_s`` and the prefetch
             thread's copy time a batch), under ``monitor = jsonl`` with
             round 1 traced (``monitor_trace_dir``): the stream passes
             the port's ``validate_records``, holds the reference's
             record kinds in its loop's order (``train_kinds``), one
             ``step`` record per update in step order, each round's
             summed ``data_wait_ms`` within ``WAIT_SHARE`` of the round
             (+ ``WAIT_SLACK_S``) of the phase's own ``data_wait_s`` and
             its ``pipeline`` copy time a batch within ``H2D_SHARE``
             (+ ``H2D_SLACK_MS``) of the tap's; the trace written, its
             size, its bn_apply kernels and its top device operations;
             a ``step`` record's host cost (``monitor_emit_us``);
             ``staging_check``: the first 4
             staged batches of an AlexNet.conf-keyed chain copied back
             equal the same chain's host batches bit for bit (data,
             labels, inst_index), and a batch-4 update from a staged
             batch gives the host batch's parameters; ``extra_input_check``:
             a net with ``extra_data_num = 1`` trained 2 rounds through
             the CLI from an imgrec, attachtxt, threadbuffer chain, every
             update from a staged batch with its extra input;
             ``pred``, ``pred_raw`` and ``extract`` (the pooled features,
             node ``flat``) over val.rec from that snapshot (a pred block
             given on the command line) with ``bn_fold_eval =
             bn_fuse_relu = conv_pallas_epilogue = 1``: 200 classes in
             0-999, 200 rows summing to 1, 69 bf16 conv_epilogue
             launches per forward, the first 4 rows and their pooled
             features against the port on the CPU (bf16 tolerances: the
             eval path runs in the conf's bf16); ``serve`` with 8 clients x 8
             requests x 4 rows, 0 failed, 69 per forward, its stream's
             ``serve_summary`` with 0 failures; and the MNIST
             snapshot quantized (``task = quantize``, the 0.05 gate) and
             served at ``serve_dtype = int8``, 0 failed.

10. alexnet — the layer-zoo slice: ``example/ImageNet/AlexNet.conf`` in
             process through the CLI (``LearnTask().run``), only its data
             paths, ``num_round`` and ``model_dir`` set from outside, on
             seeded raw-tensor imgrec archives (1,536 train and 256 val
             records of 256x256x3 uint8, labels in 0-999): 2 rounds of 6
             batches at the conf's batch 256, 227 crop, 1000 classes,
             grouped convs, two LRNs and ``dtype = bfloat16``, staged as
             in the cli phase (the round lines, every update's loss
             finite, 0002.model.npz written, exactly 8 bias_grad_bf16
             launches per update and no other, none in the round lines'
             eval forwards, each update's time and each round's rows/s
             with its ``data_wait_s`` and copy time); one profiled step
             from a host batch and one from a staged batch
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
11. checkpoint — the checkpoint and CLI slice: Inception-BN.conf through
             the CLI on the cli phase's archives (six batches of 128 a
             round, bf16, ``bn_pallas = bn_fuse_relu = 1``) under the
             reference's checkpoint defaults (``checkpoint_async = 1``):
             trained in a subprocess (``preempt_child``: the CLI's
             ``main`` with its launches counted from 0 and printed at
             exit; ``print_step = 1``, one update a dispatch) and sent
             SIGTERM with ``os.kill`` after the second round's third
             progress line: exit code 75, its ``monitor = jsonl`` stream
             valid, one ``step`` per update, ending with the emergency
             ``checkpoint`` record and ``preempt``; every update's
             launches those
             below and none outside its updates and evals, the
             model_dir holding only the emergency ``0001.model.npz``
             (counter = rounds completed; no ``.tmp``), verified, its
             ``update_counter`` the updates the progress lines counted,
             and the seconds from the signal to the exit; ``continue =
             1`` in process: rounds 2-3, the parameters before its first
             update the emergency snapshot's bit for bit; the newest
             snapshot truncated: ``continue = 1`` quarantines it
             (``0003.model.npz.quarantined``) and re-runs round 3;
             ``keep_snapshots = 2`` over 3 rounds leaves 2; a
             ``fault://`` model_dir whose ``.ok`` manifest fails leaves a
             payload that resume does not see (it starts at round 1);
             the training thread's time inside ``CheckpointManager.save``
             at the conf's snapshot bytes, async against sync (gather,
             serialize, write, fsync; printed, no bound); ``task =
             finetune`` from the resumed snapshot with fc1 remapped to
             10 classes (an archive with labels below 10): every carried
             layer the source's bits before the first update, fc1 fresh,
             then ``task = pred`` on its snapshot (the eval fold on);
             ``channel_pad = 128`` (``pad_update_check``): padded
             channels exactly 0 in a training forward and their
             cotangents exactly 0; one float32 update from the snapshot
             (cuDNN deterministic), padded and not, through the kernels
             and through their plain versions, and the unpadded plain
             path with cuDNN off as the order control: the padded
             kernels within ``PAD_KERNEL_RTOL`` and ``PAD_ORDER_SHARE``
             of the control from the padded plain path, the padding's
             own effect within ``PAD_ORDER_FACTOR`` of the control, and
             in float64 on the plain path within ``PAD_UPDATE_RTOL``,
             with no launch; ``precompile = 1``: two bf16 updates
             with and without it the same bits (cuDNN deterministic),
             round 0's first update time with and without. Every run
             launches exactly 69 + 69 bf16 bn_apply and 1 bias_grad_bf16
             per update (69 + 69 f32 bn_apply per float32 update, padded
             or not) and 69 bf16 conv_epilogue per pred forward.
12. wrapper — the Python API (``cxxnet_tpu_torch.wrapper``):
             ``Net(dev="gpu")`` from Inception-BN.conf's netconfig and
             globals (batch 128, 3x224x224, bf16; ``bn_pallas`` and the
             eval fold set through ``set_param``, ``monitor = jsonl``):
             3 updates on seeded NCHW float32 arrays, each exactly 69 +
             69 bf16 bn_apply and 1 bias_grad_bf16 launches, and its
             time; ``evaluate`` over val.rec (a finite metric);
             ``predict`` of 4 rows with 69 bf16 conv_epilogue launches,
             the same bits as ``NetTrainer.predict`` on the card from
             the net's snapshot, and its top-1 and ``extract``'s softmax
             rows and pooled features against the port on the CPU from
             that snapshot (the cli phase's bf16 tolerances); the
             snapshot loaded into a second ``Net`` gives every
             ``get_weight`` the same bits; the stream one ``step`` an
             update.
13. fleet  — the serving front end (``task = serve_fleet``'s
             ``FleetServer``) over Inception-BN.conf's net (bf16, the
             eval fold, the conf's bucket ladder up to 128 rows) from
             the wrapper phase's snapshot, its BNs calibrated: clients
             in a process of their own (HTTP 1-2 rows; CXN1 and CXN2
             1-16 rows, ``FLEET_V2_DEPTH`` in flight) and an over-quota
             tenant; a perturbed snapshot committed into the watched
             directory mid-drive: one ``hot_swap``, no failed request,
             every reply the bits of a ``ServeSession`` on the snapshot
             that served it at a bucket that could have served it, and
             every reply sent after the flip the new one's; batches of
             the ladder's top bucket among the drive's; the tenant's
             typed 429s with ``Retry-After``; ``serve_device_mem_budget``
             rejecting a second model at the router and an over-budget
             model at its engine while the first keeps serving; exactly
             69 bf16 conv_epilogue launches a served forward (the
             warmups and every dispatch) and no other; the records
             schema-valid; rows/s and p50 / p90 per protocol (printed),
             and for a window of the binary clients alone.
14. capi   — the port's C ABI (``cxxnet_tpu_torch/capi``, built with
             ``g++`` here) through ctypes on ``"gpu"`` over the same net
             text and snapshot: 3 ``CXNNetUpdateBatch`` calls (69 + 69
             bf16 bn_apply, 1 bias_grad_bf16 each), predict and extract
             of 4 rows (69 bf16 conv_epilogue a forward), the bits of
             ``wrapper.Net(dev="gpu")`` fed the same calls (cuDNN
             deterministic), a ``CXNNetGetWeight`` / ``CXNNetSetWeight``
             round trip, save / load, and a compiled C program that owns
             its interpreter predicting and extracting the softmax on
             ``"gpu"`` from the fleet phase's calibrated snapshot: the
             bits of ``Net(dev="gpu")`` on that snapshot.
15. bundle — sealed bundles of the fleet phase's net (bf16, the eval
             fold, the conf's ladder) from its calibrated snapshot:
             ``task = export`` through the CLI (8 warmed buckets, 69 bf16
             conv_epilogue each); the bundle verifies, its programs are
             the kernel libraries whose counters one served forward
             moves (``conv_epilogue``), and a member byte, the marker,
             a manifest byte and a missing marker get the reference's
             verdicts; ``task = pred`` / ``pred_raw`` / ``serve`` from the
             bundle: ``artifact_load`` every program a hit on a matching
             fingerprint, 69 bf16 conv_epilogue a forward, the raw rows
             (``output_format = bin``) the bits of ``pred_raw`` from the
             inner snapshot, a soak with no failed request; a cold start
             in a fresh process on a copy of the tree without
             ``_build/``, from the bundle (no nvcc) and from the snapshot
             (nvcc builds conv_epilogue), seconds from the spawn to the
             first reply printed with the nvcc seconds saved; and a
             watched model_dir (``0001.model.npz``) under binary clients
             of a process of their own while the CLI, each export a
             process of its own, commits ``0001.model.bundle`` and then
             a perturbed ``0002.model.bundle``: two flips (snapshot ->
             bundle at the same counter, bundle -> bundle), no failed
             request, every reply the bits of a session on the snapshot
             that served it, 69 bf16 conv_epilogue a forward, the
             commit-to-flip times printed.
16. continual — ``task = continual`` through the CLI with binary
             clients on its fleet from its boot to its last generation:
             example/MNIST/MNIST_CONTINUAL.conf as shipped on the
             tracked digits (``CONT_MNIST_OVERRIDES``: every generation
             deployed or gate-skipped, its metric printed, no failed
             request); Inception-BN.conf on the cli phase's archives
             with the eval fold (``CONT_INCEPTION_OVERRIDES``): exactly
             69 + 69 bf16 bn_apply and 1 bias_grad_bf16 an update and 69
             bf16 conv_epilogue a forward (gate evals, export warmups,
             the fleet's warmups and traffic) and no other launch;
             generation 2's export reloads the engine in place and runs
             no nvcc; its flip fails no request; the update time and
             each generation's time printed.

Then a ``phase_seconds`` line, a ``kernels`` line (every ported kernel
with its launches, error and times; ``cli_launches``,
``alexnet_launches``, ``checkpoint_launches``, ``wrapper_launches``,
``fleet_launches``, ``capi_launches``, ``bundle_launches`` and
``continual_launches``: its count over the cli phase's runs, the
alexnet phase's training run, the checkpoint phase's runs (the
preempted subprocess included), the wrapper, fleet and capi phases'
main paths, the bundle phase's runs (both cold-start processes
included; the hot-swap exports run in processes of their own and are
not counted) and the continual phase's two loops; the bias_grad_bf16
row also with AlexNet's per-update sums), the ``nvidia-smi`` line, and
the last line ``{"ok": true, "device": {...}}``.
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
                     grid: bool = True, timed: bool = True, dtypes=None,
                     lead: int = 0, nonpos: bool = False):
    """pool_concat forward and the pool branch's backward on the card
    against their plain versions on the same inputs, the same bits:
    inputs in steps of 0.5 (``grid``: tied maxima, exact zeros) or
    N(0, 9) (avg sums that round), optionally NaN in the pool branch,
    or (``nonpos``) a pool branch of values <= 0 on the 0.5 grid, so
    that the border windows' maximum is the pad's zero and the inputs
    equal to it tie with the pad; the forward also from channels-last
    views of the branches (read through their strides), the backward
    also from a permuted cotangent. ``dtypes`` gives each branch its
    own dtype (the concat's is the first's); ``lead`` > 0 makes every
    branch the channel slice [lead, lead + C) of a wider tensor (a base
    off 16 bytes). The plans' routes are recorded (the forward's per
    branch, ``kernels.pool_concat_plan``; the backward's from a dense and
    from the permuted cotangent, its tile, staged bytes, blocks and
    threads, ``kernels.pool_concat_bwd_plan``). With ``timed``: kernel,
    plain and reference times (F.pad + F.max_pool2d / F.avg_pool2d +
    torch.cat, and its autograd backward), both kernels' profiled device
    times, and the bounds."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    dtypes = list(dtypes or [dtype] * len(widths))
    dtype = dtypes[0]
    dt = _dt(dtype)
    esz = torch.empty((), dtype=dt).element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(widths) + k + h)
    ctot, cp = sum(widths), widths[pos]
    off = sum(widths[:pos])
    n_out, n_pool = batch * h * w * ctot, batch * h * w * cp
    nbuf = 2 if timed else 1

    def draw(shape, bdt):
        wide = shape[:3] + (shape[3] + 2 * lead,)
        v = torch.randn(wide, generator=gen, device=dev)
        v = (torch.round(2 * v) / 2 if grid else 3 * v).to(_dt(bdt))
        return v[..., lead:lead + shape[3]] if lead else v
    xs = [[draw((batch, h, w, c), bdt) for c, bdt in zip(widths, dtypes)]
          for _ in range(nbuf)]
    if nonpos:
        xs[0][pos].copy_(-xs[0][pos].abs())
    if nan:
        xs[0][pos].view(-1)[::997] = float("nan")
    dys = [torch.randn((batch, h, w, ctot), generator=gen, device=dev).to(dt)
           for _ in range(nbuf)]
    counts0 = kernels.launch_counts()
    out = kernels.pool_concat_fwd(xs[0], pos, k, mode)
    plan = kernels.pool_concat_fwd.last_plan
    ref = kernels.pool_concat_plain(xs[0], pos, k, mode)
    views = [x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
             for x in xs[0]]
    outv = kernels.pool_concat_fwd(views, pos, k, mode)
    dx = kernels.pool_concat_bwd(xs[0][pos], out, dys[0], off, k, mode)
    bplan = kernels.pool_concat_bwd.last_plan
    dxp = kernels.pool_concat_bwd_plain(xs[0][pos], ref, dys[0], off, k,
                                        mode)
    dyv = dys[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    dxv = kernels.pool_concat_bwd(xs[0][pos], out, dyv, off, k, mode)
    torch.cuda.synchronize()
    res = {"widths": list(widths), "pos": pos, "k": k, "mode": mode,
           "hw": [h, w], "batch": batch, "dtype": dtype, "nan": nan,
           "grid": grid, "dtypes": dtypes, "lead": lead, "nonpos": nonpos,
           "routes": plan["routes"],
           "tile": [plan["tr"], plan["tw"], plan["cc"]],
           "blocks": plan["blocks"],
           "bwd_plan": bwd_plan_record(bplan),
           "bwd_route_permuted_dy":
               kernels.pool_concat_bwd.last_plan["route"],
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
        res["fwd_device_ms"] = device_ms(
            {"k": (lambda i: kernels.pool_concat_fwd(xs[i % nbuf], pos, k,
                                                     mode),
                   "cxn_pool_concat_fwd")}, iters)["k"]
        res["fwd_plain_ms"] = cuda_time_ms(
            lambda i: kernels.pool_concat_plain(xs[i % nbuf], pos, k, mode),
            iters)
        res["bwd_ms"] = cuda_time_ms(
            lambda i: kernels.pool_concat_bwd(xs[i % nbuf][pos],
                                              outs[i % nbuf], dys[i % nbuf],
                                              off, k, mode), iters)
        res["bwd_device_ms"] = device_ms(
            {"k": (lambda i: kernels.pool_concat_bwd(
                xs[i % nbuf][pos], outs[i % nbuf], dys[i % nbuf], off, k,
                mode), "cxn_pool_concat_bwd")}, iters)["k"]
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


def bwd_plan_record(plan):
    """What a pool_concat backward launch ran: route, tile (input rows,
    cols, channels a job), what a block stages and its bytes, blocks,
    threads, the halo's re-read factor and dy's strides."""
    return {"route": plan["route"],
            "tile": [plan["tr"], plan["tw"], plan["cc"]],
            "staged": plan["staged"], "smem": plan["smem"],
            "blocks": plan["blocks"], "threads": plan["threads"],
            "reread": plan["reread"], "dy_strides": plan["dy_strides"]}


def pool_concat_section(bw: float, flops: float, dtype: str):
    """pool_concat at every fused concat of the tower's batch-128 step
    on ``dtype`` (the same shapes serve at f32), plus a ragged case
    (widths not multiples of 8, k = 5, pool branch in the middle), a
    NaN case, an N(0, 9) avg case, unaligned and mixed-dtype branches,
    the widest window the reference's gate admits on a 2 x 2 map (in
    bf16 a one-pixel tile's halo past 96 KiB of shared memory), maps
    smaller than a tile (k 3 and 5, the window wider than the map), a
    pool branch whose last job is a partial one on the vector route,
    and border ties with the pad's zero, in both modes."""
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.net import FuncNet
    cfg = tower_train_cfg_bf16 if dtype == "bfloat16" else tower_train_cfg
    tnet = FuncNet(_configured(cfg(TRAIN_BATCH)), TRAIN_BATCH)
    shapes = path_concat_shapes(tnet, TRAIN_BATCH)
    if len(shapes) != len(TOWER_FUSED[dtype]):
        raise RuntimeError("expected %d fused concats, the tower has %d"
                           % (len(TOWER_FUSED[dtype]), len(shapes)))
    path = [pool_concat_case(*sh, bw, flops, dtype) for sh in shapes]
    other = "float32" if dtype == "bfloat16" else "bfloat16"
    extra = [pool_concat_case((13, 7, 5, 19), 2, 5, "max", 28, 28, 16, bw,
                              flops, dtype, timed=False),
             pool_concat_case((13, 7, 5, 19), 2, 5, "avg", 28, 28, 16, bw,
                              flops, dtype, timed=False),
             pool_concat_case((64, 96, 128, 928), 3, 3, "max", 14, 14, 32,
                              bw, flops, dtype, nan=True, timed=False),
             pool_concat_case((64, 64, 96, 192), 3, 3, "avg", 28, 28, 16,
                              bw, flops, dtype, grid=False, timed=False),
             # every branch a channel slice whose base is off 16 bytes
             # (the scalar route), and branches of both dtypes, the pool
             # branch of the other one (staged with a cast)
             pool_concat_case((64, 64, 96, 192), 3, 3, "max", 28, 28, 16,
                              bw, flops, dtype, lead=2, timed=False),
             pool_concat_case((64, 64, 96, 192), 2, 3, "avg", 28, 28, 16,
                              bw, flops, dtype, grid=False, timed=False,
                              dtypes=[dtype, other, dtype, other]),
             pool_concat_case((64, 64, 96, 192), 1, 3, "max", 14, 14, 16,
                              bw, flops, dtype, timed=False,
                              dtypes=[dtype, other, dtype, other])]
    esz = 2 if dtype == "bfloat16" else 4
    wide = max(k for k in range(3, 201, 2)
               if kernels.pool_concat_applicable(2, 2, 16, k, esz))
    extra += [pool_concat_case((8, 8), 1, wide, mode, 2, 2, 2, bw, flops,
                               dtype, grid=mode == "max", timed=False)
              for mode in ("max", "avg")]
    # a map smaller than one tile, the window at and past its size; a
    # pool branch of 40 channels (a partial last job on the vector
    # route); pool branches <= 0, so that border inputs tie with the pad
    for mode in ("max", "avg"):
        extra += [pool_concat_case((16, 32), 1, kk, mode, 3, 5, 4, bw, flops,
                                   dtype, timed=False) for kk in (3, 5)]
        extra += [pool_concat_case((32, 40, 24), 1, 3, mode, 28, 28, 8, bw,
                                   flops, dtype, timed=False),
                  pool_concat_case((64, 96, 128, 928), 3, 3, mode, 14, 14, 8,
                                   bw, flops, dtype, timed=False,
                                   nonpos=True)]
    keys = ("fwd_ms", "fwd_device_ms", "fwd_plain_ms", "fwd_bound_ms",
            "reference_fwd_ms", "bwd_ms", "bwd_device_ms", "bwd_plain_ms",
            "bwd_bound_ms", "reference_bwd_ms")
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
            "fwd_routes": [c["routes"] for c in cases],
            "bwd_routes": [[c["bwd_plan"]["route"],
                            c["bwd_route_permuted_dy"]] for c in cases],
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


def bf16_edge_classes(seed: int = SEED, n: int = 20000):
    """Pairs (a, b) of bf16 bit patterns (numpy uint16 arrays) by class,
    on which the bias gradient's native bf16 add must equal an f32 add
    rounded to bf16: ``random``, ``n`` seeded patterns (NaN and inf
    included); ``subnormal``, subnormals with subnormals and with the
    smallest normals; ``signed_zero``, x + -x, the four +-0 pairs and 0
    plus a subnormal; ``gap``, exponents 8, 16, 17, 24 and 31-40 apart
    (halfway and near-halfway cases at 8); ``inf``, +-inf with each other
    and with finite values; ``largest``, the largest finite values with
    large ones (sums that overflow)."""
    rng = np.random.RandomState(seed)
    m = 1000

    def word(sign, exp, man):
        return (np.asarray(sign) << 15) | (np.asarray(exp) << 7) \
            | np.asarray(man)

    def sgn():
        return rng.randint(0, 2, m)

    def man():
        return rng.randint(0, 128, m)
    out = {"random": ([rng.randint(0, 1 << 16, n)],
                      [rng.randint(0, 1 << 16, n)]),
           "subnormal": ([word(sgn(), 0, man()), word(sgn(), 0, man())],
                         [word(sgn(), 0, man()),
                          word(sgn(), rng.randint(1, 3, m), man())])}
    z = np.array([0x0000, 0x8000], dtype=np.int64)
    x = word(sgn(), rng.randint(0, 255, m), man())
    out["signed_zero"] = ([np.repeat(z, 2), x, np.repeat(z, m // 2)],
                          [np.tile(z, 2), x ^ 0x8000, word(sgn(), 0, man())])
    ga, gb = [], []
    for gap in (8, 16, 17, 24) + tuple(range(31, 41)):
        ea = rng.randint(gap + 1, 255, m)
        ga.append(word(sgn(), ea, man()))
        gb.append(word(sgn(), ea - gap, man()))
        if gap == 8:
            ga.append(word(sgn(), ea, man()))
            gb.append(word(sgn(), ea - gap, rng.choice([0, 1, 127], m)))
    out["gap"] = (ga, gb)
    inf = np.array([0x7f80, 0xff80], dtype=np.int64)
    out["inf"] = ([np.repeat(inf, 2), np.repeat(inf, m // 2)],
                  [np.tile(inf, 2), word(sgn(), rng.randint(0, 255, m),
                                         man())])
    out["largest"] = ([word(sgn(), 254, rng.randint(120, 128, m))],
                      [word(sgn(), rng.randint(240, 255, m), man())])
    return {k: (np.concatenate(a).astype(np.uint16),
                np.concatenate(b).astype(np.uint16))
            for k, (a, b) in out.items()}


def bf16_edge_pairs(seed: int = SEED, n: int = 20000):
    """Every class of :func:`bf16_edge_classes` in one pair of arrays."""
    cls = bf16_edge_classes(seed, n).values()
    return np.concatenate([a for a, _ in cls]), \
        np.concatenate([b for _, b in cls])


def bf16_add_probe(n: int = 1 << 20):
    """The bias gradient's add (``add.rn.bf16x2``, through
    ``kernels.bf16_add_pairs``) against PyTorch's bf16 add (an f32 add
    rounded to bf16) on :func:`bf16_edge_pairs`, the same bits (NaN's
    payload apart); and the latency of one dependent add, from one
    warp's chains of n and 2n adds (``kernels.bf16_add_chain``): CUDA
    events around each (ns per add from their difference), and the SM
    cycles ``clock64`` counts over the 2n chain, beside the SM clock
    ``nvidia-smi`` reads after it."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    ua, ub = bf16_edge_pairs()
    if len(ua) % 2:
        ua, ub = ua[:-1], ub[:-1]

    def as_bf16(u):
        return torch.from_numpy(u.astype(np.int16)).view(
            torch.bfloat16).to(dev)
    a, b = as_bf16(ua), as_bf16(ub)
    got = kernels.bf16_add_pairs(a, b)
    ref = a + b
    zero_signs = bool(torch.equal(
        got[ref == 0].view(torch.int16), ref[ref == 0].view(torch.int16)))
    res = {"pairs": int(a.numel()), "exact": bits_equal(got, ref),
           "zero_signs_kept": zero_signs,
           "subnormal_sums": int(((ref != 0) & (ref.abs() < 2.0 ** -126))
                                 .sum())}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn(128, generator=gen, device=dev).to(torch.bfloat16)
    times = {}
    for chain in (n, 2 * n):
        times[chain] = cuda_time_ms(lambda i: kernels.bf16_add_chain(x, chain),
                                    3, warmup=1)
    _, cycles = kernels.bf16_add_chain(x, 2 * n)
    res["chain_adds"] = [n, 2 * n]
    res["chain_ms"] = [times[n], times[2 * n]]
    res["ns_per_add"] = (times[2 * n] - times[n]) * 1e6 / n
    res["cycles_per_add"] = float(cycles.item()) / (2 * n)
    res["sm_clock"] = nvidia_smi_query("clocks.sm")
    res["ok"] = res["exact"] and zero_signs and res["ns_per_add"] > 0
    return res


def nvidia_smi_query(field: str) -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not measured"
    out = subprocess.run([exe, "--query-gpu=" + field,
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "not measured"


def bias_edge_dy(shape, kind: str):
    """A bf16 cotangent of ``shape`` drawn from the edge classes:
    ``"tiny"`` subnormals, signed zeros and the smallest normals (the
    sums stay subnormal or small); ``"mixed"`` finite values of both
    signs from the subnormals up to 2^33 (sums that absorb their terms
    or round at a tie), with channel 0 sprinkled with +-inf, channel 1
    with NaN, channel 2 holding the largest finite values (sums that
    overflow) and channel 3 signed zeros only."""
    import torch
    rng = np.random.RandomState(SEED + 17 + len(kind))
    n = int(np.prod(shape))
    sign = rng.randint(0, 2, n) << 15
    if kind == "tiny":
        bits = sign | (rng.randint(0, 2, n) << 7) | rng.randint(0, 128, n)
    else:
        bits = sign | (rng.randint(0, 160, n) << 7) | rng.randint(0, 128, n)
        bits = bits.reshape(-1, shape[-1])
        rows = bits.shape[0]
        pick = rng.rand(rows) < 0.01
        bits[pick, 0] = rng.choice([0x7f80, 0xff80], int(pick.sum()))
        pick = rng.rand(rows) < 0.01
        bits[pick, 1] = 0x7fc0
        bits[:, 2] = (bits[:, 2] & 0x8000) | 0x7f7f
        bits[:, 3] &= 0x8000
    t = torch.from_numpy(np.asarray(bits).astype(np.uint16).astype(np.int16))
    return t.view(torch.bfloat16).reshape(shape).to(DEVICE)


def bias_grad_case(shape, bw: float, flops: float, ns_per_add=None,
                   dy=None, tag: str = "", timed: bool = True,
                   route=None):
    """The bf16 bias gradient on the card against its plain version (the
    same bits), also from a permuted cotangent (4-D); the route of each
    pass (``kernels.bias_grad_plan``). With ``timed``: kernel and plain
    times, torch.sum's (f32 accumulation, one rounding: another
    function's bits, the yardstick of a reduction), the bytes bound, and
    the chain floor: the plan's longest-window adds times one dependent
    add's ``ns_per_add`` (``bf16_add_probe``); torch.sum's time both by
    events and by the profiler, as the kernel's. ``dy`` replaces the
    N(0, 9) cotangent (an edge-class or strided one); ``route``, where
    given, is the route the first pass must take."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3 + sum(shape))
    n, c = int(np.prod(shape)), shape[-1]
    if dy is None:
        dy = (3 * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
    counts0 = kernels.launch_counts()
    got = kernels.bias_grad_bf16(dy)
    plan = kernels.bias_grad_bf16.last_plan
    ref = kernels.bias_grad_bf16_plain(dy)
    same = bits_equal(got, ref)
    if len(shape) == 4:
        dyv = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        same = same and bits_equal(kernels.bias_grad_bf16(dyv), ref)
    torch.cuda.synchronize()
    axes = tuple(range(len(shape) - 1))
    fin = torch.isfinite(got) & torch.isfinite(ref)
    out = {"shape": list(shape), "tag": tag, "exact": same, "ok": same,
           "max_abs_err": float((got - ref)[fin].abs().max())
           if bool(fin.any()) else 0.0,
           "nonfinite": int((~torch.isfinite(ref)).sum()),
           "passes": len(plan["passes"]), "routes": plan["routes"],
           "groups": plan["groups"], "chain": plan["chain"]}
    if route is not None and plan["routes"][0] != route:
        out["ok"] = False
        out["error"] = "first pass took %s, not %s" % (plan["routes"][0],
                                                       route)
    if timed:
        # read dy, write the f32 sums; one add per element
        out["bound_ms"], out["bound_by"] = bound(2 * n + 4 * c, n, bw, flops)
        out["chain_bound_ms"] = plan["chain"] * ns_per_add * 1e-6 \
            if ns_per_add else None
        out["ms"] = cuda_time_ms(lambda i: kernels.bias_grad_bf16(dy), 10)
        dev = device_ms(
            {"k": (lambda i: kernels.bias_grad_bf16(dy), "cxn_bias"),
             "library": (lambda i: torch.sum(dy, axes), "")}, 10)
        out["device_ms"] = dev["k"]
        out["library_device_ms"] = dev["library"]
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
                      expected: int = KAIMING_BF16_LAUNCHES["bias_grad_bf16"],
                      ns_per_add=None):
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
    cases = {sh: bias_grad_case(sh, bw, flops, ns_per_add)
             for sh in sorted(set(shapes), key=lambda v: -int(np.prod(v)))}
    counts = [shapes.count(sh) for sh in cases]
    vals = list(cases.values())
    return {"ok": all(c["ok"] for c in vals),
            "launches_per_step": len(shapes),
            "step_sum": _step_of(vals, ("ms", "device_ms", "plain_ms",
                                        "library_ms", "library_device_ms",
                                        "bound_ms", "chain_bound_ms"),
                                 counts),
            "chain_per_step": sum(c["chain"] * k
                                  for c, k in zip(vals, counts)),
            "max_abs_err": max(c["max_abs_err"] for c in vals),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in vals) else "operations",
            "library": "torch.sum over all but the channel (f32 "
                       "accumulation, one rounding: not the reference's "
                       "bits)",
            "cases": [dict(c, count=k) for c, k in zip(vals, counts)]}


def bias_grad_extra(bw: float, flops: float):
    """The bias gradient where the redesign's routes and the add's edges
    are: edge-class cotangents (subnormal and signed-zero sums; every
    class, inf and NaN among them) over padded windows, an odd C and a
    C % 8 != 0 (the direct route), fullc (N, C) shapes (one of three
    passes), a cotangent whose base is not 16-byte aligned, and ring
    windows whose lines (or planes) are shorter than the copier's
    cursor step, dense and batch-strided; the same bits as the plain
    version."""
    import torch
    big = torch.randn((64, 14, 14, 66), device=DEVICE).to(torch.bfloat16)
    # every other item of a batch: a batch stride twice the item's
    tall = torch.randn((128, 27, 27, 64), device=DEVICE).to(torch.bfloat16)
    flat = torch.randn((128, 1, 4, 64), device=DEVICE).to(torch.bfloat16)
    cases = [bias_grad_case((64, 33, 35, 64), bw, flops, tag="edge_tiny",
                            dy=bias_edge_dy((64, 33, 35, 64), "tiny"),
                            timed=False),
             bias_grad_case((64, 33, 35, 64), bw, flops, tag="edge_mixed",
                            dy=bias_edge_dy((64, 33, 35, 64), "mixed"),
                            timed=False),
             bias_grad_case((64, 14, 14, 77), bw, flops, tag="odd_c",
                            timed=False),
             bias_grad_case((128, 7, 7, 100), bw, flops, tag="c_100",
                            timed=False),
             bias_grad_case((256, 4096), bw, flops, tag="fullc",
                            timed=False),
             bias_grad_case((3000, 100), bw, flops, tag="fullc_3_passes",
                            timed=False),
             bias_grad_case((128, 10), bw, flops, tag="fullc_c10",
                            timed=False),
             bias_grad_case((64, 14, 14, 64), bw, flops, tag="unaligned",
                            dy=big[..., 1:65], timed=False),
             # 32 channels a block, a cursor step of 8 rows over lines
             # of 4 (windows of 25 x 4 rows); 16 channels, 16 rows over
             # lines of 8; planes of 4 rows under a step of 8
             bias_grad_case((8, 50, 4, 64), bw, flops, tag="ring_short_lines",
                            timed=False, route="ring"),
             bias_grad_case((128, 45, 8, 64), bw, flops,
                            tag="ring_short_lines_g16", timed=False,
                            route="ring"),
             bias_grad_case((64, 27, 27, 64), bw, flops,
                            tag="ring_batch_strided", dy=tall[::2],
                            timed=False, route="ring"),
             bias_grad_case((64, 1, 4, 64), bw, flops,
                            tag="ring_short_planes_strided", dy=flat[::2],
                            timed=False, route="ring")]
    del big, tall, flat
    return {"ok": all(c["ok"] for c in cases), "cases": cases}


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
    # the bias gradient's add on the card, and its latency (the chain
    # floor's unit)
    probe = bf16_add_probe()
    bias = bias_grad_section(bw, flops, ns_per_add=probe["ns_per_add"])
    # the layer-zoo slice: AlexNet.conf's 8 biases at its batch 256
    bias_alex = bias_grad_section(bw, flops, alexnet_cfg(ALEX_BATCH),
                                  ALEX_BATCH, ALEX_LAUNCHES["bias_grad_bf16"],
                                  ns_per_add=probe["ns_per_add"])
    bias_extra = bias_grad_extra(bw, flops)
    ok = ok and all(v["ok"] for v in pc.values()) \
        and all(c["ok"] for c in bwd_bf16) and bias["ok"] \
        and bias_alex["ok"] and probe["ok"] and bias_extra["ok"]
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
           "bias_grad_bf16_alexnet": bias_alex, "bf16_add": probe,
           "bias_grad_bf16_extra": bias_extra}
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


def recorder():
    """The serve phases' telemetry: the port's monitor over an in-memory
    sink (``rec.sink.records``)."""
    from cxxnet_tpu_torch.monitor import MemorySink, Monitor
    return Monitor(MemorySink())


def tail_report(records, t0: float, n: int = 6):
    """Exact request-latency percentiles of a drive (with how many
    samples lie beyond each), and its slowest requests and batches with
    when they happened (seconds after ``t0``, the records' clock)."""
    reqs = [r for r in records if r["event"] == "serve_request"]
    bats = [r for r in records if r["event"] == "serve_batch"]
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
    rec.sink.clear()
    t_drive = time.time()
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
            "tails": tail_report(rec.sink.records, t_drive),
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
    rec = recorder()
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
    rec = recorder()
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
                    data, labels, mask, _ = t._device_batch(batch)
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


def drive_train(cfg, expected, device_keys, probe=None):
    """The training main path at batch TRAIN_BATCH: a seeded trainer
    from ``cfg``, 2 warm and 10 timed ``update`` steps on one batch
    (CUDA events and host clock), every step's launches against
    ``expected`` (counts set to 0 just before, read just after), the
    losses, peak memory and a profiled step; then ``probe(trainer,
    batch)``, if given, under ``probe``. Returns (trainer, result)."""
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
    if probe is not None:
        res["probe"] = probe(t, batch)
    return t, res


def tower_bwd_routes(t, batch):
    """The plan of every pool_concat backward launch of one more update
    (``kernels.pool_concat_bwd_plan``, recorded as the wrapper asks for
    it; launch counts restored: not a main-path run), each printed."""
    from cxxnet_tpu_torch.layers import kernels
    plans, inner = [], kernels._pool_concat_bwd_plan

    def record(*args):
        plans.append(inner(*args))
        return plans[-1]
    counts = kernels.launch_counts()
    kernels._pool_concat_bwd_plan = record
    try:
        t.update(batch)
    finally:
        kernels._pool_concat_bwd_plan = inner
        kernels.restore_launch_counts(counts)
    recs = [bwd_plan_record(p) for p in plans]
    for i, r in enumerate(recs):
        print("tower pool_concat backward %d: route %s, tile %s, dy strides "
              "%s" % (i, r["route"], r["tile"], r["dy_strides"]), flush=True)
    return recs


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


def vec_routes(recs, expected) -> bool:
    """Every pool_concat backward launch of an update took the vector
    route, as many as ``expected`` counts a step (on the CPU, where no
    kernel launches, none)."""
    n = sum(v for k, v in expected.items() if k.startswith("pool_concat_bwd"))
    return DEVICE == "cpu" and not recs or (
        len(recs) == n and all(r["route"] == "vec" for r in recs))


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
                        TOWER_DEVICE_KEYS, probe=tower_bwd_routes)
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
    tr["bwd_routes"] = tr.pop("probe")
    tr["bwd_vec"] = vec_routes(tr["bwd_routes"], TOWER_LAUNCHES)
    tr["ok"] = bool(tr["counted"] and tr["loss_falls"]
                    and tr["update_vs_cpu"]["ok"] and tr["bwd_vec"])
    # bench-set training: the drive, the batch-4 check against the card's
    # bf16 plain path
    tb, br = drive_train(tower_train_cfg_bf16(TRAIN_BATCH),
                         TOWER_BF16_LAUNCHES, TOWER_DEVICE_KEYS,
                         probe=tower_bwd_routes)
    br["fused"] = sorted(tb.net.fused_concats.values())
    br["bwd_routes"] = br.pop("probe")
    br["bwd_vec"] = vec_routes(br["bwd_routes"], TOWER_BF16_LAUNCHES)
    del tb
    torch.cuda.empty_cache()
    br["update_vs_plain"] = bf16_update_check(
        workdir, tower_train_cfg_bf16(4), TOWER_BF16_LAUNCHES, "tower4_bf16")
    br["ok"] = bool(br["counted"] and br["loss_falls"]
                    and br["update_vs_plain"]["ok"] and br["bwd_vec"])
    # f32 serving from a snapshot of the tower
    cfg = tower_serve_cfg()
    rng = np.random.RandomState(SEED + 8)
    init = NetTrainer(cfg, device=DEVICE)
    init.init_model()
    calibrate_bn(init, init.to_device_batch(images(rng, 32)))
    path = os.path.join(workdir, "tower_224.model.npz")
    init.save_model(path)
    del init
    rec = recorder()
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
# archives (256x256x3 uint8, labels in 0-999): 6 full batches of 128 a
# round (rounds reach a steady state), and a validation archive
CLI_IMAGE = 256
CLI_TRAIN_RECORDS, CLI_VAL_RECORDS = 768, 200
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
    throughput and staging copies (each staged batch's copy timed in
    the prefetch thread, to its ``ready`` event, apart from the
    pipeline's own counters); the methods are restored on exit."""
    import threading
    import torch
    from cxxnet_tpu_torch.io.iter_batch import PrefetchIterator
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    names = ("update", "update_many", "pred", "end_round")
    orig = {n: getattr(NetTrainer, n) for n in names}
    orig_transform = PrefetchIterator.set_transform
    copies, copies_lock = [], threading.Lock()
    for key in ("updates", "forwards", "rounds"):
        rec.setdefault(key, [])

    def set_transform(self, fn, pin_memory=False):
        def timed(batch):                # runs in the prefetch thread
            t0 = time.perf_counter()
            out = fn(batch)
            if getattr(out, "ready", None) is not None:
                out.ready.synchronize()
            with copies_lock:
                copies.append(time.perf_counter() - t0)
            return out
        return orig_transform(self, timed, pin_memory)

    def on_card(t):
        return isinstance(t, torch.Tensor) and t.device.type == DEVICE

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
                            for b in batches),
                # the batches arrived staged on the card (data, labels
                # and every extra input)
                "staged": all(on_card(b.data) and on_card(b.label)
                              and all(on_card(e) for e in b.extra_data)
                              for b in batches),
                "extra_inputs": len(batches[0].extra_data)})
        return run

    def pred(self, data, nodes, mask=None, extra=()):
        before = kernels.launch_counts()
        out = orig["pred"](self, data, nodes, mask, extra)
        rec["forwards"].append(delta(before))
        return out

    def end_round(self):
        was_open = self._round_t0 is not None
        orig["end_round"](self)
        if was_open:
            # the prefetch thread's copies this round (its epoch has
            # ended: the loop read the end of the iterator)
            with copies_lock:
                h2d = list(copies)
                copies.clear()
            rec["rounds"].append({
                "round": self.round, "examples": self.last_round_examples,
                "wall_s": self.last_round_wall_s,
                "rows_per_s": self.last_round_examples_per_sec,
                "h2d_batches": len(h2d), "h2d_ms": sum(h2d) * 1e3,
                "staging": dict(self.staging)})

    NetTrainer.update = stepped(orig["update"])
    NetTrainer.update_many = stepped(orig["update_many"])
    NetTrainer.pred = pred
    NetTrainer.end_round = end_round
    PrefetchIterator.set_transform = set_transform
    try:
        yield rec
    finally:
        for n in names:
            setattr(NetTrainer, n, orig[n])
        PrefetchIterator.set_transform = orig_transform


def round_report(rec, per_round: int):
    """The CLI training run's rounds (``tap_trainer``): each round's
    rows/s, its update seconds and the rest of its window
    (``data_wait_s``: the loop waiting on the iterator), the prefetch
    thread's copy time per staged batch, and how many batches were staged
    from the pinned ring; the updates' median (the first apart)."""
    step_ms = [u["ms"] for u in rec["updates"]]
    rounds = []
    for i, rd in enumerate(rec["rounds"]):
        upd = sum(step_ms[i * per_round:(i + 1) * per_round]) / 1e3
        rounds.append({
            "round": rd["round"], "rows_per_s": rd["rows_per_s"],
            "wall_s": rd["wall_s"], "update_s": upd,
            "data_wait_s": rd["wall_s"] - upd,
            "h2d_batches": rd["h2d_batches"],
            "h2d_ms_per_batch": rd["h2d_ms"] / rd["h2d_batches"]
            if rd["h2d_batches"] else None})
    staging = rec["rounds"][-1]["staging"] if rec["rounds"] else {}
    return {"rounds": rounds, "first_update_ms": step_ms[0]
            if step_ms else None,
            "update_median_ms": float(np.median(step_ms[1:]))
            if len(step_ms) > 1 else None,
            "staged_updates": sum(u["staged"] for u in rec["updates"]),
            "staging": staging,
            "pinned_ring": bool(staging.get("batches"))
            and staging.get("pinned") == staging.get("batches")}


# the telemetry checks: a round's data wait by the step records against
# the phase's own (its window less its updates), and the staging copy a
# batch by the pipeline record against the tap's; each within this
# share of the round's wall time (or batch copy) plus the absolute slack
# of a host clock read
WAIT_SHARE, WAIT_SLACK_S = 0.02, 0.05
H2D_SHARE, H2D_SLACK_MS = 0.05, 0.2
CLI_TRACE_ROUND = 1


def train_kinds(rounds: int, per_round: int, trace_round: int):
    """The record kinds the reference's train loop
    (``cxxnet_tpu/main.py`` ``_task_train``) emits for a run whose rounds
    go through the round tail alone (``dispatch_period`` past the round's
    batches, so no progress line), its first update a first sighting,
    an eval of the train metric and of one eval block each round, the
    trace over ``trace_round``; the writer thread's ``checkpoint``
    records (their place is its timing) and warnings apart."""
    out = ["model_info", "layout", "run_start"]
    for r in range(rounds):
        out.append("round_start")
        if r == trace_round:
            out.append("trace_start")
        out += (["compile"] if r == 0 else []) + ["step"] * per_round
        out += ["eval", "weight_residency", "eval", "log"]
        if r == trace_round:
            out.append("trace_stop")
        out += ["round_end", "memory", "io_wait", "pipeline"]
    return out + ["log", "run_end"]


def stream_report(recs, rep, n_updates: int, per_round: int,
                  rounds: int, trace_round: int):
    """The train run's record stream against the reference's vocabulary
    and loop (:func:`train_kinds`), its step records against the updates
    the tap saw, and by round its data wait and staging copies against
    the phase's own (:func:`round_report`); both sides printed."""
    from cxxnet_tpu_torch.monitor.schema import validate_records
    errs = validate_records(recs, strict=False)
    kinds = [r["event"] for r in recs
             if r["event"] not in ("checkpoint", "warning")]
    steps = [r for r in recs if r["event"] == "step"]
    pipes = {r["round"]: r for r in recs if r["event"] == "pipeline"}
    by_round = []
    for rd in rep["rounds"]:
        r = rd["round"]
        wait = sum(x["data_wait_ms"] for x in steps if x["round"] == r) / 1e3
        p = pipes.get(r, {})
        rec_copy = p["h2d_ms"] / p["h2d_batches"] \
            if p.get("h2d_batches") else None
        tap_copy = rd["h2d_ms_per_batch"]
        by_round.append({
            "round": r, "records_data_wait_s": wait,
            "phase_data_wait_s": rd["data_wait_s"],
            "wait_agrees": abs(wait - rd["data_wait_s"])
            <= WAIT_SHARE * rd["wall_s"] + WAIT_SLACK_S,
            "records_h2d_ms_per_batch": rec_copy,
            "phase_h2d_ms_per_batch": tap_copy,
            "h2d_overlap_ratio": p.get("h2d_overlap_ratio"),
            "h2d_agrees": rec_copy is not None and tap_copy is not None
            and abs(rec_copy - tap_copy) <= H2D_SHARE * tap_copy
            + H2D_SLACK_MS})
    ck = [r for r in recs if r["event"] == "checkpoint"]
    out = {
        "records": len(recs), "schema_errors": errs[:5],
        "kinds_match": kinds == train_kinds(rounds, per_round,
                                            trace_round),
        "steps": len(steps),
        "steps_in_order": [x["step"] for x in steps]
        == list(range(1, n_updates + 1))
        and all(x["n_batches"] == 1 for x in steps),
        "step_wall_ms": [x["wall_ms"] for x in steps],
        "checkpoints": [(x["counter"], x["status"], x["async_write"])
                        for x in ck],
        "warnings": [x["code"] for x in recs if x["event"] == "warning"],
        "by_round": by_round}
    out["ok"] = bool(
        not errs and out["kinds_match"] and len(steps) == n_updates
        and out["steps_in_order"]
        and out["checkpoints"] == [(r + 1, "ok", True)
                                   for r in range(rounds)]
        and all(b["wait_agrees"] and b["h2d_agrees"] for b in by_round))
    return out


def trace_report(recs, n: int = 8):
    """The trace window's Chrome trace (the ``trace_stop`` record's
    path): its size, the kernels the profiler saw, the bn_apply kernels
    among them, the device time by kind (``kind_of``) and the top device
    operations by summed time (kernels by name, template arguments
    dropped)."""
    stop = [r for r in recs if r["event"] == "trace_stop"]
    if not stop or not os.path.exists(stop[0]["path"]):
        return {"ok": False, "error": "no trace written"}
    path = stop[0]["path"]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    by, kinds = {}, {}
    for e in kern:
        us = float(e.get("dur", 0))
        name = re.sub(r"^void ", "", e["name"]).split("<")[0].split("(")[0]
        by[name] = by.get(name, 0.0) + us
        k = kind_of(e["name"])
        kinds[k] = kinds.get(k, 0.0) + us
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    out = {"rounds": [r["round"] for r in recs
                      if r["event"] in ("trace_start", "trace_stop")],
           "bytes": os.path.getsize(path), "events": len(events),
           "kernels": len(kern), "device_ms": sum(by.values()) / 1e3,
           "bn_fwd_kernels": sum("cxn_bn_fwd" in e["name"] for e in kern),
           "bn_bwd_kernels": sum("cxn_bn_bwd" in e["name"] for e in kern),
           "by_kind_ms": {k: v / 1e3 for k, v in sorted(
               kinds.items(), key=lambda kv: -kv[1])},
           "top_device_ms": [[k, v / 1e3] for k, v in top]}
    out["ok"] = bool(out["bn_fwd_kernels"] and out["bn_bwd_kernels"])
    return out


def monitor_emit_us(workdir: str, n: int = 2000) -> float:
    """Host microseconds a ``step`` record costs ``monitor = jsonl``
    (assembly, JSON, the buffered write), over ``n`` records."""
    from cxxnet_tpu_torch.monitor import JsonlSink, Monitor
    mon = Monitor(JsonlSink(os.path.join(workdir, "emit.jsonl")))
    fields = dict(step=1, round=0, dispatch="update", n_batches=1,
                  examples=128, wall_ms=130.0, data_wait_ms=5.0,
                  examples_per_sec=984.6, update_counter=1, lr=0.01,
                  compile=False)
    t0 = time.perf_counter()
    for i in range(n):
        mon.emit("step", **fields)
    mon.close()
    return (time.perf_counter() - t0) / n * 1e6


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


def staging_check(rec_path: str, nbatch: int = 4):
    """The staging on the card, held bit for bit: the first ``nbatch``
    batches of a threadbuffer chain over ``rec_path`` (AlexNet.conf's
    train keys at batch 4: imgrec, 227 rand_crop, rand_mirror,
    mean_value) staged by ``NetTrainer.device_put_batch`` from the
    pinned ring, copied back to the host, against the same chain's
    batches read with no transform, in the same process (data, labels,
    inst_index, padding); and one batch-4 AlexNet.conf update from the
    first staged batch against one from its host batch, from one seed,
    cuDNN deterministic: the same parameters."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch, create_iterator
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    pairs = [("iter", "imgrec"), ("path_imgrec", rec_path),
             ("input_shape", "3,227,227"), ("rand_crop", "1"),
             ("rand_mirror", "1"), ("mean_value", "123,117,104"),
             ("silent", "1"), ("iter", "threadbuffer")]

    def first(trainer):
        it = create_iterator(pairs, [("batch_size", "4")])
        it.init()
        out = []
        try:
            if trainer is not None:
                it.set_transform(trainer.device_put_batch,
                                 pin_memory=DEVICE == "cuda")
            for b in it:
                out.append(b if trainer is not None else DataBatch(
                    np.array(b.data), np.array(b.label),
                    np.array(b.inst_index), b.num_batch_padd))
                if len(out) == nbatch:
                    break
        finally:
            it.close()
        return out

    stager = NetTrainer(alexnet_cfg(4), device=DEVICE)
    host, staged = first(None), first(stager)
    same = []
    for h, d in zip(host, staged):
        stager._await(d)
        same.append({
            "data": exact(torch.from_numpy(h.data), d.data.cpu()),
            "label": exact(torch.from_numpy(h.label), d.label.cpu())
            and np.array_equal(h.label, d.host_label),
            "inst_index": np.array_equal(h.inst_index, d.inst_index),
            "padd": h.num_batch_padd == d.num_batch_padd,
            "on_card": d.data.device.type == DEVICE})
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    params = []
    try:
        for stage in (False, True):
            t = NetTrainer(alexnet_cfg(4) + [("eval_train", "0")],
                           device=DEVICE)
            t.init_model()
            t.update(t.device_put_batch(host[0]) if stage else host[0])
            params.append({(lk, tag): w.detach().cpu()
                           for lk, sub in t.params.items()
                           for tag, w in sub.items()})
            del t
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = before
    differing = [("%s/%s" % k) for k in params[0]
                 if not exact(params[0][k], params[1][k])]
    res = {"batches": len(staged), "per_batch": same,
           "staging": dict(stager.staging),
           "update_params_differing": differing}
    res["ok"] = bool(len(staged) == len(host) == nbatch
                     and all(all(c.values()) for c in same)
                     and not differing
                     and stager.staging["batches"] >= nbatch
                     and (stager.staging["pinned"]
                          == stager.staging["batches"]
                          or DEVICE != "cuda"))
    return res


EXTRA_TEXT = """data = train
iter = imgrec
  path_imgrec = %(rec)s
  input_shape = 3,32,32
  rand_crop = 1
  mean_value = 123,117,104
  scale = 0.0078125
  silent = 1
iter = attachtxt
  filename = %(att)s
iter = threadbuffer
iter = end
extra_data_num = 1
extra_data_shape[0] = 1,1,%(dim)d
netconfig = start
layer[in->c1] = conv:c1
  kernel_size = 5
  stride = 2
  nchannel = 16
layer[c1->c1] = relu
layer[c1->p1] = max_pooling
  kernel_size = 3
  stride = 2
layer[p1->f] = flatten
layer[f,in_1->h] = concat
layer[h->fc1] = fullc:fc1
  nhidden = 64
layer[fc1->fc1] = relu
layer[fc1->o] = fullc:fc2
  nhidden = %(nclass)d
layer[o->o] = softmax
netconfig = end
input_shape = 3,32,32
batch_size = 32
eta = 0.05
momentum = 0.9
metric = error
"""


def extra_input_check(workdir: str, rec_path: str, dim: int = 8):
    """A net with an extra input (``extra_data_num = 1``: the image's
    conv features concatenated with an ``attachtxt`` row a record) trained
    2 rounds through the CLI on the card, its chain imgrec, attachtxt,
    threadbuffer: every update from a batch staged on the card, the
    extra input included, its loss finite."""
    rng = np.random.RandomState(SEED + 21)
    att = os.path.join(workdir, "extra.txt")
    with open(att, "w") as f:
        f.write("%d\n" % dim)
        for i in range(CLI_VAL_RECORDS):
            f.write(" ".join([str(i)] + ["%.5f" % v for v in
                                         rng.randn(dim)]) + "\n")
    conf = os.path.join(workdir, "extra.conf")
    with open(conf, "w") as f:
        f.write(EXTRA_TEXT % {"rec": rec_path, "att": att, "dim": dim,
                              "nclass": NCLASS})
    rec = {}
    with tap_trainer(rec):
        rc, lines = run_cli([conf, "num_round=2", "print_step=0",
                             "model_dir=" + os.path.join(workdir, "extra")])
    ups = rec["updates"]
    losses = [u["loss"] for u in ups]
    res = {"rc": rc, "updates": len(ups), "losses": losses,
           "staged_updates": sum(u["staged"] for u in ups),
           "extra_inputs": sorted(set(u["extra_inputs"] for u in ups)),
           "staging": rec["rounds"][-1]["staging"] if rec["rounds"] else {},
           "round_lines": round_lines(lines)}
    res["ok"] = bool(rc == 0 and len(ups) == 2 * -(-CLI_VAL_RECORDS // 32)
                     and res["staged_updates"] == len(ups)
                     and res["extra_inputs"] == [1]
                     and np.all(np.isfinite(losses)))
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

    # train: the conf's own batch 128, 224 crop, 1000 classes and dtype,
    # its record stream in JSONL and round CLI_TRACE_ROUND traced
    stream_path = os.path.join(workdir, "cli_train.jsonl")
    tr = drive("train", [conf, "task=train", "bn_pallas=1",
                         "bn_fuse_relu=1", "num_round=%d" % CLI_ROUNDS,
                         "print_step=1", "model_dir=" + mdir,
                         "monitor=jsonl", "monitor_path=" + stream_path,
                         "monitor_trace_dir="
                         + os.path.join(workdir, "trace"),
                         "monitor_trace_begin=%d" % CLI_TRACE_ROUND,
                         "monitor_trace_end=%d" % CLI_TRACE_ROUND])
    snap = os.path.join(mdir, "%04d.model.npz" % CLI_ROUNDS)
    ups = tr["updates"]
    per_round = -(-CLI_TRAIN_RECORDS // TRAIN_BATCH)
    evals = CLI_ROUNDS * -(-CLI_VAL_RECORDS // TRAIN_BATCH)
    losses = [u["loss"] for u in ups]
    step_ms = [u["ms"] for u in ups]
    lines = round_lines(tr["lines"])
    # a round's window (start_round to end_round) less its updates: the
    # time the loop waited on the iterator (decode, augment and the copy
    # in the threadbuffer's thread)
    rep = round_report(tr, per_round)
    from cxxnet_tpu_torch.monitor.schema import read_jsonl
    recs = read_jsonl(stream_path) if os.path.exists(stream_path) else []
    stream = stream_report(recs, rep, len(ups), per_round, CLI_ROUNDS,
                           CLI_TRACE_ROUND)
    trace = trace_report(recs)
    traced = step_ms[CLI_TRACE_ROUND * per_round:
                     (CLI_TRACE_ROUND + 1) * per_round]
    train = {
        "rc": tr["rc"], "wall_s": tr["wall_s"], "archives_s": archives_s,
        "round_lines": lines, "updates": len(ups), "losses": losses,
        "finite": bool(np.all(np.isfinite(losses))),
        "step_ms": step_ms,
        # the untraced round's updates, its first apart (monitor = jsonl)
        "steady_step_ms": float(np.median(step_ms[1:per_round]))
        if per_round > 1 and len(step_ms) >= per_round else None,
        "traced_step_ms": float(np.median(traced)) if traced else None,
        "first_update_ms": rep["first_update_ms"],
        "stream": stream, "trace": trace,
        "monitor_emit_us": monitor_emit_us(workdir),
        "rows_per_update": [u["rows"] for u in ups],
        "rounds": rep["rounds"], "staging": rep["staging"],
        "pinned_ring": rep["pinned_ring"],
        "staged_updates": rep["staged_updates"],
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
                       and stream["ok"] and trace["ok"]
                       and sorted(lines) == list(range(1, CLI_ROUNDS + 1))
                       and all("train-error" in v and "val-error" in v
                               for v in lines.values())
                       and train["staged_updates"] == len(ups)
                       and (train["pinned_ring"] or DEVICE != "cuda"))
    # the staged batches against the host ones, and a staged update
    # against a host one; an extra_data_num net trained from an
    # attachtxt chain
    staging = staging_check(train_rec)
    extra_input = extra_input_check(workdir, val_rec)
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
    serve_path = os.path.join(workdir, "cli_serve.jsonl")
    sr = drive("serve", [conf, "task=serve", "model_in=" + snap] + knobs
               + CLI_SOAK + ["serve_buckets=" + BUCKETS, "pred=serve.txt",
                             "monitor=jsonl", "monitor_path=" + serve_path]
               + block)
    soak = serve_line(sr["lines"]) or {}
    srecs = read_jsonl(serve_path) if os.path.exists(serve_path) else []
    summ = [r for r in srecs if r["event"] == "serve_summary"]
    serve = dict(soak, rc=sr["rc"], wall_s=sr["wall_s"],
                 forwards=len(sr["forwards"]), launches=sr["launches"],
                 expected_per_forward=CLI_PRED_LAUNCHES,
                 summary_record={k: summ[0][k] for k in (
                     "requests", "rows", "batches", "rejected", "timeouts",
                     "errors", "latency_p50_ms", "latency_p99_ms")}
                 if summ else None)
    serve["counted"] = bool(sr["forwards"] and all(
        f == CLI_PRED_LAUNCHES for f in sr["forwards"]))
    serve["ok"] = bool(sr["rc"] == 0 and soak.get("failed") == 0
                       and soak.get("ok") == 64 and serve["counted"]
                       and len(summ) == 1 and summ[0]["requests"] == 64
                       and summ[0]["rejected"] == summ[0]["timeouts"]
                       == summ[0]["errors"] == 0
                       and srecs[-1]["event"] == "task_end")
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
           "mnist": mnist, "train": train, "staging_check": staging,
           "extra_input": extra_input, "pred": preds, "serve": serve,
           "launches": total}
    res["ok"] = bool(mnist["ok"] and mnist["quantize"]["ok"]
                     and mnist["serve_int8"]["ok"] and train["ok"]
                     and staging["ok"] and extra_input["ok"]
                     and preds["ok"] and serve["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("cli phase failed")
    return res


# ------------------------------------------------------------ phase 10

# the layer-zoo slice: example/ImageNet/AlexNet.conf through the CLI, its
# data on seeded raw-tensor imgrec archives (256x256x3 uint8, labels in
# 0-999): six full batches of 256 a round, and one validation batch
ALEX_TRAIN_RECORDS, ALEX_VAL_RECORDS = 1536, 256
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
    rep = round_report(tr, per_round)
    train = {
        "rc": tr["rc"], "wall_s": tr["wall_s"], "archives_s": archives_s,
        "round_lines": lines, "updates": len(ups), "losses": losses,
        "finite": bool(np.all(np.isfinite(losses))), "step_ms": step_ms,
        "first_update_ms": rep["first_update_ms"],
        "update_median_ms": rep["update_median_ms"],
        "rows_per_update": [u["rows"] for u in ups],
        "rounds": rep["rounds"], "staging": rep["staging"],
        "pinned_ring": rep["pinned_ring"],
        "staged_updates": rep["staged_updates"],
        "launches": tr["launches"],
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
                               for v in lines.values())
                       and train["staged_updates"] == len(ups)
                       and (train["pinned_ring"] or DEVICE != "cuda"))
    # one step of the conf's net at its batch, profiled (a seeded
    # trainer from the same keys), and the LRNs' own device time
    t = NetTrainer(alexnet_cfg(ALEX_BATCH) + [("eval_train", "0")],
                   device=DEVICE)
    t.init_model()
    b = alexnet_batch(np.random.RandomState(SEED + 13), ALEX_BATCH)
    t.update(b)
    prof = profile_step(t, b, reps=3, device_keys=ALEX_DEVICE_KEYS)
    # the update as the CLI now runs it: its batch staged beforehand
    staged_prof = profile_step(t, t.device_put_batch(b), reps=3,
                               device_keys=ALEX_DEVICE_KEYS)
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
           "train": train, "profile": prof,
           "profile_staged": {k: staged_prof[k] for k in (
               "wall_ms", "device_busy_ms", "idle_share", "spread",
               "by_kind")}, "pred": preds,
           "update_vs_plain": bdelta, "zoo": zoo,
           "launches": runs["train"]["launches"]}
    res["ok"] = bool(train["ok"] and preds["ok"] and bdelta["ok"]
                     and zoo["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("alexnet phase failed")
    return res


# ------------------------------------------------------------ phase 11

# the checkpoint and CLI slice: Inception-BN.conf through the CLI under the
# reference's checkpoint defaults (checkpoint_async = 1), preempted by
# SIGTERM, resumed, quarantined, finetuned; its rounds are the cli phase's
# six batches of 128
CKPT_SIGNAL_AFTER = 3          # updates of the second round before SIGTERM
CKPT_FT_CLASSES = 10           # the finetuned head (fc1) width
CKPT_FT_RECORDS = 256          # finetune archive: two batches, labels < 10
CKPT_UPDATES = 2               # channel_pad / precompile kernel updates
CKPT_CROP = 224                # Inception-BN.conf's input crop
CKPT_PAD = 128                 # channel_pad: full 128-lane alignment
# channel_pad = 128 against the unpadded net, float32, one update of
# Inception-BN-224 from one snapshot on one batch (cuDNN deterministic),
# as ||d_a - d_b|| / ||d_b|| over the whole logical update. The padded
# convolutions and batch-norm sums run at other widths, so cuDNN and the
# reductions sum in another order, and the float32 update of this net
# is ill-conditioned (update_delta_check): no float32 run is held to
# another within a fixed 1e-3. Held: (a) the padded net through the
# kernels against the padded net through their plain versions (the
# kernels at the padded widths, the same convolutions) within
# PAD_KERNEL_RTOL and within PAD_ORDER_SHARE of the order control, the
# unpadded plain path with cuDNN off (every convolution summed in
# another order); (b) the padding's own effect on the plain path within
# PAD_ORDER_FACTOR of that control; (c) the padded plain update in
# float64 (batch 16) within PAD_UPDATE_RTOL of the unpadded one, which
# takes about nine digits off any change of order and leaves a fault of
# the padding as large as it is.
PAD_KERNEL_RTOL = 5e-2
PAD_ORDER_SHARE = 0.5
PAD_ORDER_FACTOR = 2.0
PAD_UPDATE_RTOL = 1e-6
PAD_F64_BATCH = 16
CKPT_F32_LAUNCHES = dict(NO_LAUNCHES, bn_apply_fwd=69, bn_apply_bwd=69)
_PROGRESS = re.compile(r"^round +(\d+):\[ *(\d+)\]")


@contextlib.contextmanager
def first_update_params(rec):
    """Keep, in ``rec["params"]``, host copies of the parameters of the
    first ``NetTrainer`` update of the block, taken just before it."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    orig = {n: getattr(NetTrainer, n) for n in ("update", "update_many")}

    def wrap(fn):
        def run(self, arg):
            if "params" not in rec:
                rec["params"] = {
                    "param/%s/%s" % (lk, tag): v.detach().cpu().numpy()
                    for lk, sub in self.params.items()
                    for tag, v in sub.items()}
            return fn(self, arg)
        return run

    for n, fn in orig.items():
        setattr(NetTrainer, n, wrap(fn))
    try:
        yield rec
    finally:
        for n, fn in orig.items():
            setattr(NetTrainer, n, fn)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


PREEMPT_TAG = "preempt_child "


def preempt_child(argv) -> int:
    """The preempted run's process (:func:`preempt_run` starts it):
    ``cxxnet_tpu_torch.main.main(argv)`` with the launch counts set to 0
    just before it and every update and eval forward tapped
    (:func:`tap_trainer`); on every exit path one ``PREEMPT_TAG`` line
    with each update's and each forward's launches and the process's
    total."""
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.main import main as cli_main
    rec, rc = {}, 1
    kernels.reset_launch_counts()
    try:
        with tap_trainer(rec):
            rc = cli_main(list(argv))
    finally:
        print(PREEMPT_TAG + json.dumps({
            "updates": [u["launches"] for u in rec.get("updates", [])],
            "forwards": rec.get("forwards", []),
            "total": kernels.launch_counts()}), flush=True)
    return rc


def preempt_run(conf: str, mdir: str, workdir: str):
    """The conf trained in a subprocess (:func:`preempt_child`;
    print_step = 1, one update a dispatch, the reference's checkpoint
    defaults, ``monitor = jsonl``); SIGTERM with ``os.kill`` once the
    second round's ``CKPT_SIGNAL_AFTER``-th progress line is read.
    Returns rc, the updates the progress lines counted, the seconds from
    the signal to the exit, the child's launches, the end of its record
    stream and the output's tail."""
    import signal
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH", "")) if p))
    cmd = [sys.executable, "-c", "import sys, chip_smoke; "
           "sys.exit(chip_smoke.preempt_child(sys.argv[1:]))", conf,
           "bn_pallas=1", "bn_fuse_relu=1", "num_round=4", "print_step=1",
           "dispatch_period=1", "model_dir=" + mdir, "monitor=jsonl",
           "monitor_path=" + os.path.join(workdir, "preempt.jsonl")] \
        + cli_dev_args()
    lines, t_sig, t_exit = [], None, None
    errp = os.path.join(workdir, "preempt_stderr.txt")
    t0 = time.perf_counter()
    with open(errp, "w") as err:
        p = subprocess.Popen(cmd, cwd=workdir, env=env,
                             stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            for ln in p.stdout:
                lines.append(ln.rstrip("\n"))
                m = _PROGRESS.match(ln)
                if (t_sig is None and m and int(m.group(1)) == 1
                        and int(m.group(2)) == CKPT_SIGNAL_AFTER):
                    t_sig = time.perf_counter()
                    os.kill(p.pid, signal.SIGTERM)
            rc = p.wait(timeout=300)
            t_exit = time.perf_counter()
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(errp) as f:
        tail = f.read()[-2000:]
    child = next((json.loads(ln[len(PREEMPT_TAG):]) for ln in lines
                  if ln.startswith(PREEMPT_TAG)), None)
    from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
    sp = os.path.join(workdir, "preempt.jsonl")
    recs = read_jsonl(sp) if os.path.exists(sp) else []
    tail2 = [{k: r.get(k) for k in ("event", "counter", "emergency",
                                    "status", "signal", "round",
                                    "exit_code")} for r in recs[-2:]]
    stream = {"records": len(recs),
              "schema_errors": validate_records(recs, strict=False)[:5],
              "steps": sum(r["event"] == "step" for r in recs),
              "last_two": tail2}
    stream["ok"] = bool(
        not stream["schema_errors"] and len(tail2) == 2
        and tail2[0]["event"] == "checkpoint" and tail2[0]["emergency"]
        and tail2[0]["status"] == "ok" and tail2[1]["event"] == "preempt"
        and tail2[1]["exit_code"] == 75)
    return {"rc": rc, "wall_s": time.perf_counter() - t0, "child": child,
            "stream": stream,
            "updates": sum(bool(_PROGRESS.match(ln)) for ln in lines),
            "signal_to_exit_s": None if t_sig is None else t_exit - t_sig,
            "preempt_line": next((ln for ln in lines
                                  if ln.startswith("preempted by")), ""),
            "stderr_tail": tail if rc != 75 else ""}


def finetune_conf(workdir: str, rec_path: str) -> str:
    """Inception-BN.conf with fc1 at ``CKPT_FT_CLASSES`` outputs and both
    data blocks on ``rec_path`` (labels below that width)."""
    conf = shipped_conf(workdir, "Inception-BN.conf", rec_path, rec_path)
    with open(conf) as f:
        text = f.read()
    old = "layer[flat->fc] = fullc:fc1\n  nhidden = %d\n" % NCLASS
    assert text.count(old) == 1, old
    text = text.replace(old, "layer[flat->fc] = fullc:fc1\n  nhidden = "
                        "%d\n" % CKPT_FT_CLASSES)
    path = os.path.join(workdir, "Inception-BN-ft.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


def write_ft_archive(workdir: str) -> str:
    from cxxnet_tpu_torch.io import recordio
    rng = np.random.RandomState(SEED + 11)
    path = os.path.join(workdir, "ft.rec")
    w = recordio.RecordIOWriter(path)
    for i in range(CKPT_FT_RECORDS):
        img = rng.randint(0, 256, (CLI_IMAGE, CLI_IMAGE, 3), dtype=np.uint8)
        w.write_record(recordio.pack_raw_tensor_record(
            i, float(rng.randint(CKPT_FT_CLASSES)), img))
    w.close()
    return path


def pad_zero_check(t, data, labels):
    """Every padded channel of every node of one training forward holds
    exactly 0, and the loss's cotangent there is exactly 0."""
    import torch
    from cxxnet_tpu_torch.nnet.layout import is_padded
    net = t.net
    padded = [ni for ni, lay in enumerate(net.node_layouts)
              if is_padded(lay)]
    params = {lk: {k: v.detach().requires_grad_(v.is_floating_point())
                   for k, v in sub.items()} for lk, sub in t.params.items()}
    nonzero = grad_nonzero = 0
    with torch.enable_grad():
        nodes, _, logits = net.forward(params, t.net_state, data, True,
                                       collect_logits=True)
        for ni in padded:
            if nodes[ni].requires_grad:
                nodes[ni].retain_grad()
        loss = sum(net.layer_objs[li].loss_value(v, labels, None)
                   for li, v in logits.items())
        loss.backward()
    for ni in padded:
        off = 0
        for valid, pad in net.node_layouts[ni]:
            gap = slice(off + valid, off + valid + pad)
            nonzero += int(torch.count_nonzero(nodes[ni][..., gap]))
            g = nodes[ni].grad
            if g is not None:
                grad_nonzero += int(torch.count_nonzero(g[..., gap]))
            off += valid + pad
    return {"padded_nodes": len(padded), "nonzero": nonzero,
            "grad_nonzero": grad_nonzero,
            "ok": bool(padded and nonzero == 0 and grad_nonzero == 0)}


def keyed_updates(cfg, snap, batch, precompile=False):
    """A trainer from ``snap`` under ``cfg``, ``CKPT_UPDATES``
    updates on one batch; its parameters on the host, each update's
    launches and time (the first is round 0's first update), and the
    precompile seconds."""
    import torch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    t = NetTrainer(cfg, device=DEVICE)
    t.load_model(snap)
    pre_s = None
    if precompile:
        t0 = time.perf_counter()
        t.precompile()
        pre_s = time.perf_counter() - t0
    ups = []
    for _ in range(CKPT_UPDATES):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        t.update(batch)
        loss = t.last_loss
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        ups.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                    "launches": {k: after[k] - before[k] for k in after}})
    params = {"%s/%s" % (lk, tag): v.detach().double().cpu()
              for lk, sub in t.params.items() for tag, v in sub.items()}
    return t, params, ups, pre_s


def pad_update_check(cfg, snap, x, y):
    """``channel_pad = CKPT_PAD`` against the unpadded net (the tolerance
    notes above ``PAD_KERNEL_RTOL``). float32 runs from ``snap`` on one
    batch, cuDNN deterministic: the kernels and their plain versions
    (:func:`plain_kernels`), each padded and unpadded, and the unpadded
    plain path with cuDNN off; d = w_after - w_before of one update over
    the logical parameters. The kernel runs take a second update on the
    same batch for its time and check every update's launches
    (``CKPT_F32_LAUNCHES``); the plain runs must launch nothing. The
    padded kernel run's trainer also goes through :func:`pad_zero_check`
    (its launches, a check's, are held to one update's and set back).
    Then one update in float64 on the plain path (batch
    ``PAD_F64_BATCH``), padded against unpadded, no launch."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    f32 = [("dtype", "float32")]
    pad = [("channel_pad", str(CKPT_PAD))]
    batch = DataBatch(data=x.to(DEVICE), label=y.to(DEVICE))
    out = {}

    def launched(fn):
        before = kernels.launch_counts()
        fn()
        after = kernels.launch_counts()
        return {k: after[k] - before[k] for k in after}

    def run(extra, plain=False, cudnn=True):
        t = NetTrainer(list(cfg) + f32 + extra, device=DEVICE)
        t.load_model(snap)
        w0 = {(lk, tg): w.detach().double().cpu()
              for lk, sub in t.params.items() for tg, w in sub.items()}
        cudnn_was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn
        rec = {"ms": [], "launches": []}
        try:
            with plain_kernels() if plain else contextlib.nullcontext():
                for i in range(1 if plain else CKPT_UPDATES):
                    t0 = time.perf_counter()
                    rec["launches"].append(launched(lambda: t.update(batch)))
                    loss = t.last_loss
                    torch.cuda.synchronize()
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
                    if i == 0:
                        rec["loss"] = loss
                        d = {k: t.params[k[0]][k[1]].detach().double()
                             .cpu() - w0[k] for k in w0}
        finally:
            torch.backends.cudnn.enabled = cudnn_was
        if extra and not plain:
            counts = kernels.launch_counts()
            zero = {}
            rec["check_launches"] = launched(lambda: zero.update(
                pad_zero_check(t, x[:4].to(DEVICE), y[:4].to(DEVICE))))
            kernels.restore_launch_counts(counts)
            out["zeros"] = zero
            out["layout"] = dict(t.net.layout_summary)
        del t
        torch.cuda.empty_cache()
        return d, rec

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {"pad_kernels": run(pad), "pad_plain": run(pad, plain=True),
                "kernels": run([]), "plain": run([], plain=True),
                "plain_no_cudnn": run([], plain=True, cudnn=False)}
    finally:
        torch.backends.cudnn.deterministic = det
    keys, table, whole = update_distances(runs, (
        ("pad_kernels", "pad_plain"), ("kernels", "plain"),
        ("pad_plain", "plain"), ("pad_kernels", "kernels"),
        ("plain_no_cudnn", "plain")))
    control = whole["plain_no_cudnn_vs_plain"]
    recs = {n: r[1] for n, r in runs.items()}
    kernel_runs = ("pad_kernels", "kernels")
    out.update(
        params=len(keys), whole=whole,
        worst={n: max(v) for n, v in table.items()},
        worst_param={n: "%s/%s" % keys[int(np.argmax(v))]
                     for n, v in table.items()},
        losses={n: r["loss"] for n, r in recs.items()},
        loss_rel=abs(recs["pad_kernels"]["loss"] - recs["pad_plain"]["loss"])
        / abs(recs["pad_plain"]["loss"]),
        update_ms={n: recs[n]["ms"] for n in kernel_runs},
        launches={n: recs[n]["launches"] for n in recs},
        counted=all(u == CKPT_F32_LAUNCHES for n in kernel_runs
                    for u in recs[n]["launches"]),
        plain_launch_free=all(not any(u.values()) for n in recs
                              if n not in kernel_runs
                              for u in recs[n]["launches"]),
        check_launches_one_update=(recs["pad_kernels"]["check_launches"]
                                   == CKPT_F32_LAUNCHES),
        rtol=PAD_KERNEL_RTOL, order_share=PAD_ORDER_SHARE,
        order_factor=PAD_ORDER_FACTOR,
        held=["loss_rel <= LOSS_RTOL",
              "pad_kernels_vs_pad_plain <= rtol and <= order_share * "
              "plain_no_cudnn_vs_plain",
              "pad_plain_vs_plain <= order_factor * "
              "plain_no_cudnn_vs_plain",
              "f64_update_rel_dist <= f64_rtol"])

    def f64_update(extra):
        t = NetTrainer(inception_plain_cfg(cfg) + f32 + extra,
                       device=DEVICE)
        t.load_model(snap)
        _as_float64(t)
        w0 = {(lk, tg): w.detach().cpu().clone()
              for lk, sub in t.params.items() for tg, w in sub.items()}
        data, labels, mask, _ = t._device_batch(DataBatch(
            data=x[:PAD_F64_BATCH].to(DEVICE),
            label=y[:PAD_F64_BATCH].to(DEVICE)))
        n = launched(lambda: t._train_step(
            data.double(), labels, mask, t.update_counter, True, False,
            t._step_scalar()))
        d = {k: t.params[k[0]][k[1]].detach().cpu() - w0[k] for k in w0}
        del t
        torch.cuda.empty_cache()
        return d, n

    f64 = {"plain": f64_update([]), "pad_plain": f64_update(pad)}
    _, _, f64_whole = update_distances(
        {n: (d, None) for n, (d, _) in f64.items()},
        (("pad_plain", "plain"),))
    out.update(
        f64_update_rel_dist=f64_whole["pad_plain_vs_plain"],
        f64_batch=PAD_F64_BATCH, f64_rtol=PAD_UPDATE_RTOL,
        f64_launch_free=all(not any(n.values()) for _, n in f64.values()),
        finite=bool(np.all(np.isfinite(list(out["losses"].values())))))
    out["ok"] = bool(
        out["layout"]["layers_padded"] > 0 and out["zeros"]["ok"]
        and out["check_launches_one_update"] and out["counted"]
        and out["plain_launch_free"] and out["f64_launch_free"]
        and out["finite"] and out["loss_rel"] <= LOSS_RTOL
        and whole["pad_kernels_vs_pad_plain"] <= PAD_KERNEL_RTOL
        and whole["pad_kernels_vs_pad_plain"] <= PAD_ORDER_SHARE * control
        and whole["pad_plain_vs_plain"] <= PAD_ORDER_FACTOR * control
        and out["f64_update_rel_dist"] <= PAD_UPDATE_RTOL)
    return out


def phase_checkpoint(workdir: str):
    """The checkpoint and CLI slice (see the module docstring)."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.main import EXIT_PREEMPTED
    from cxxnet_tpu_torch.nnet.checkpoint import (CheckpointManager,
                                                  read_snapshot,
                                                  scan_snapshots,
                                                  verify_snapshot)
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import (parse_cli_overrides,
                                               parse_config_file)
    from cxxnet_tpu_torch.utils.faultfs import FaultFS
    train_rec = os.path.join(workdir, "train.rec")
    val_rec = os.path.join(workdir, "val.rec")
    if not (os.path.exists(train_rec) and os.path.exists(val_rec)):
        train_rec, val_rec = write_cli_archives(workdir)
    conf = shipped_conf(workdir, "Inception-BN.conf", train_rec, val_rec)
    train_knobs = ["bn_pallas=1", "bn_fuse_relu=1"]
    per_round = -(-CLI_TRAIN_RECORDS // TRAIN_BATCH)
    runs = {}
    total = dict(NO_LAUNCHES)

    def drive(name, argv, first=False):
        rec = {}
        kernels.reset_launch_counts()            # each run from 0
        t1 = time.perf_counter()
        with tap_trainer(rec):
            if first:
                with first_update_params(rec):
                    rc, lines = run_cli(argv)
            else:
                rc, lines = run_cli(argv)
        rec.update(rc=rc, lines=lines, wall_s=time.perf_counter() - t1,
                   launches=kernels.launch_counts())
        for k in total:
            total[k] += rec["launches"][k]
        runs[name] = rec
        return rec

    def counted(rec, expected=CLI_TRAIN_LAUNCHES):
        return bool(rec["updates"] and all(
            u["launches"] == expected for u in rec["updates"]))

    # 1. preemption: a subprocess, SIGTERM after the second round's third
    # update line; rc 75, the emergency snapshot under counter 1
    mdir = os.path.join(workdir, "ckpt")
    pre = preempt_run(conf, mdir, workdir)
    # the child's launches: every update at CLI_TRAIN_LAUNCHES, one per
    # progress line, and nothing launched outside its updates and evals
    child = pre.pop("child") or {"updates": [], "forwards": [],
                                 "total": dict(NO_LAUNCHES)}
    ups, fwds = child["updates"], child["forwards"]
    pre["launches"] = {
        "updates": len(ups), "forwards": len(fwds),
        "per_update": all(u == CLI_TRAIN_LAUNCHES for u in ups),
        "total": child["total"],
        "total_is_updates_and_forwards": child["total"] == {
            k: sum(u[k] for u in ups + fwds) for k in child["total"]}}
    for k in total:
        total[k] += child["total"][k]
    names = sorted(os.listdir(mdir)) if os.path.isdir(mdir) else []
    emerg = os.path.join(mdir, "0001.model.npz")
    ver = verify_snapshot(emerg)
    _, emeta = read_snapshot(emerg) if ver["ok"] else (None, {})
    pre.update(files=names, verified=ver["ok"],
               update_counter=emeta.get("update_counter"),
               expected_updates=per_round + CKPT_SIGNAL_AFTER)
    pre["ok"] = bool(
        pre["rc"] == EXIT_PREEMPTED and pre["stream"]["ok"]
        and pre["stream"]["steps"] == pre["updates"]
        and names == ["0001.model.npz"]
        and ver["ok"] and pre["update_counter"] == pre["updates"]
        and pre["updates"] >= per_round + CKPT_SIGNAL_AFTER
        and pre["preempt_line"].endswith("0001.model.npz")
        and pre["launches"]["updates"] == pre["updates"]
        and pre["launches"]["per_update"]
        and pre["launches"]["total_is_updates_and_forwards"])
    emerg_blob = {}
    if ver["ok"]:
        blob, _ = read_snapshot(emerg)
        emerg_blob = {k: v for k, v in blob.items() if k.startswith("param/")}
    # 2. resume in process: round 2 from its start, the parameters
    # before the first update the emergency snapshot's, bit for bit
    rs = drive("resume", [conf, "continue=1", "num_round=3",
                          "model_dir=" + mdir] + train_knobs, first=True)
    got = rs.get("params", {})
    resume = {
        "rc": rs["rc"], "wall_s": rs["wall_s"],
        "round_lines": sorted(round_lines(rs["lines"])),
        "updates": len(rs["updates"]),
        "params_bit_exact": bool(emerg_blob) and sorted(got) == sorted(
            emerg_blob) and all(same_bits(got[k], emerg_blob[k])
                                for k in emerg_blob),
        "counted": counted(rs),
        "finite": bool(np.all(np.isfinite([u["loss"]
                                            for u in rs["updates"]]))),
        # monitor = none, beside the cli phase's monitored steady_step_ms
        # (both timed to a device sync by the tap)
        "steady_step_ms": float(np.median([u["ms"] for u in
                                           rs["updates"][1:]]))
        if len(rs["updates"]) > 1 else None}
    resume["ok"] = bool(rs["rc"] == 0 and resume["round_lines"] == [2, 3]
                        and resume["updates"] == 2 * per_round
                        and resume["params_bit_exact"]
                        and resume["counted"] and resume["finite"])
    # 3. quarantine, retention and a fault:// model_dir
    newest = os.path.join(mdir, "0003.model.npz")
    with open(newest, "rb") as f:
        head = f.read()
    with open(newest, "wb") as f:
        f.write(head[:len(head) // 2])
    qr = drive("quarantine", [conf, "continue=1", "num_round=3",
                              "model_dir=" + mdir] + train_knobs)
    qnames = sorted(os.listdir(mdir))
    quarantine = {"rc": qr["rc"], "files": qnames,
                  "round_lines": sorted(round_lines(qr["lines"])),
                  "counted": counted(qr)}
    quarantine["ok"] = bool(
        qr["rc"] == 0 and "0003.model.npz.quarantined" in qnames
        and quarantine["round_lines"] == [3] and quarantine["counted"]
        and verify_snapshot(newest)["ok"])
    kdir = os.path.join(workdir, "keep")
    kp = drive("keep", [conf, "num_round=3", "keep_snapshots=2",
                        "model_dir=" + kdir] + train_knobs)
    keep = {"rc": kp["rc"], "files": sorted(os.listdir(kdir)),
            "counted": counted(kp)}
    keep["ok"] = bool(kp["rc"] == 0 and keep["counted"] and keep["files"]
                      == ["0002.model.npz", "0003.model.npz"])
    fs = FaultFS("fault").install()
    try:
        fs.fail_write_substr = ".ok"
        f1 = drive("fault", [conf, "num_round=1", "model_dir=fault://ck"]
                   + train_knobs)
        payload = "fault://ck/0001.model.npz" in fs.store
        invisible = scan_snapshots("fault://ck") == []
        fs.clear_faults()
        f2 = drive("fault_resume", [conf, "num_round=1", "continue=1",
                                    "model_dir=fault://ck"] + train_knobs)
        fault = {"rc": [f1["rc"], f2["rc"]], "payload_written": payload,
                 "uncommitted_invisible": invisible,
                 "resume_round_lines": sorted(round_lines(f2["lines"])),
                 "committed_after": [c for c, _ in
                                     scan_snapshots("fault://ck")],
                 "counted": counted(f1) and counted(f2)}
        fault["ok"] = bool(fault["rc"] == [0, 0] and payload and invisible
                           and fault["resume_round_lines"] == [1]
                           and fault["committed_after"] == [1]
                           and fault["counted"])
    finally:
        fs.uninstall()
    # 4. the training thread's time inside save(), async against sync,
    # at Inception-BN.conf's snapshot bytes
    cfg = parse_config_file(conf) + parse_cli_overrides(train_knobs)
    snap = os.path.join(mdir, "0003.model.npz")
    t = NetTrainer(cfg, device=DEVICE)
    t.load_model(snap)
    saves = {}
    for mode, async_ in (("async", True), ("sync", False)):
        ck = CheckpointManager(
            t, lambda c, m=mode: os.path.join(workdir, "save_" + m,
                                              "%04d.model.npz" % c),
            async_=async_)
        ms = []
        for c in (1, 2, 3):
            ck.save(c)
            ms.append(dict(ck.last_save))
            ck.wait()
        ck.close()
        saves[mode] = {"save_ms": [m["save_ms"] for m in ms],
                       "gather_ms": [m["gather_ms"] for m in ms],
                       "commit": {k: ck.last_commit.get(k) for k in (
                           "bytes", "serialize_ms", "write_ms", "fsync_ms",
                           "status")}}
    saves["ok"] = all(saves[m]["commit"]["status"] == "ok"
                      for m in ("async", "sync"))
    del t
    torch.cuda.empty_cache()
    # 5. finetune from step 2's snapshot with fc1 remapped to 10 classes;
    # the carried layers the source's bits, fc1 fresh; then pred
    ft_rec = write_ft_archive(workdir)
    ftconf = finetune_conf(workdir, ft_rec)
    fdir = os.path.join(workdir, "ft")
    src, _ = read_snapshot(snap)
    fr = drive("finetune", [ftconf, "task=finetune", "model_in=" + snap,
                            "finetune_remap=fc1", "num_round=1",
                            "model_dir=" + fdir] + train_knobs, first=True)
    got = fr.get("params", {})
    carried = [k for k in got if not k.startswith("param/fc1/")]
    ft_counts = dict(CLI_TRAIN_LAUNCHES)
    fts = os.path.join(fdir, "0001.model.npz")
    knobs = ["%s=%s" % kv for kv in KNOBS]
    pred_out = os.path.join(workdir, "ft_pred.txt")
    pr = drive("finetune_pred", [ftconf, "task=pred", "model_in=" + fts]
               + knobs + ["pred=" + pred_out])
    cls = np.loadtxt(pred_out, ndmin=1) if pr["rc"] == 0 else np.zeros(0)
    finetune = {
        "rc": fr["rc"], "updates": len(fr["updates"]),
        "carried_bit_exact": bool(carried) and all(
            same_bits(got[k], src[k]) for k in carried),
        "carried": len(carried),
        "fc1_shape": list(got.get("param/fc1/wmat", np.zeros(0)).shape),
        "fc1_fresh": "param/fc1/wmat" in got and got[
            "param/fc1/wmat"].shape != src["param/fc1/wmat"].shape,
        "counted": counted(fr, ft_counts),
        "snapshot": verify_snapshot(fts)["ok"],
        "pred_rc": pr["rc"], "pred_rows": int(cls.shape[0]),
        "pred_classes_ok": bool(cls.size and np.all(
            (cls >= 0) & (cls < CKPT_FT_CLASSES))),
        "pred_forwards": len(pr["forwards"]),
        "pred_counted": bool(pr["forwards"]) and all(
            f == CLI_PRED_LAUNCHES for f in pr["forwards"])}
    finetune["ok"] = bool(
        fr["rc"] == 0 and finetune["carried_bit_exact"]
        and finetune["fc1_fresh"] and finetune["counted"]
        and finetune["snapshot"] and pr["rc"] == 0
        and finetune["pred_rows"] == CKPT_FT_RECORDS
        and finetune["pred_classes_ok"] and finetune["pred_counted"])
    # 6. channel_pad = 128 and precompile = 1 from one snapshot on one
    # batch: float32 (the pad check) and the conf's bf16 (precompile)
    rng = np.random.RandomState(SEED + 12)
    x = torch.from_numpy(rng.randn(TRAIN_BATCH, CKPT_CROP, CKPT_CROP, 3)
                         .astype(np.float32) * 50)
    y = torch.from_numpy(rng.randint(0, NCLASS, (TRAIN_BATCH, 1))
                         .astype(np.float32))
    batch = DataBatch(data=x.to(DEVICE), label=y.to(DEVICE))
    kernels.reset_launch_counts()
    pad = pad_update_check(cfg, snap, x, y)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ta, a_p, a_u, _ = keyed_updates(cfg, snap, batch)
        del ta
        torch.cuda.empty_cache()
        tb, b_p, b_u, pre_s = keyed_updates(cfg, snap, batch,
                                            precompile=True)
        del tb
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    prec = {"precompile_s": pre_s,
            "first_update_ms": a_u[0]["ms"],
            "first_update_ms_precompiled": b_u[0]["ms"],
            "second_update_ms": [a_u[1]["ms"], b_u[1]["ms"]],
            "bit_exact": sorted(a_p) == sorted(b_p) and all(
                torch.equal(a_p[k], b_p[k]) for k in a_p),
            "counted": all(u["launches"] == CLI_TRAIN_LAUNCHES
                           for u in a_u + b_u)}
    prec["ok"] = bool(prec["bit_exact"] and prec["counted"])
    for k in total:
        total[k] += kernels.launch_counts()[k]
    res = {"phase": "checkpoint", "model": "Inception-BN.conf",
           "config": "example/ImageNet/Inception-BN.conf on the cli "
                     "phase's archives (%d train records: %d batches of "
                     "%d a round), 224 crop, %d classes, dtype = bfloat16, "
                     "bn_pallas = bn_fuse_relu = 1, the reference's "
                     "checkpoint defaults (checkpoint_async = 1)"
                     % (CLI_TRAIN_RECORDS, per_round, TRAIN_BATCH, NCLASS),
           "preempt": pre, "resume": resume, "quarantine": quarantine,
           "keep_snapshots": keep, "fault": fault, "save": saves,
           "finetune": finetune, "channel_pad": pad, "precompile": prec,
           "run_wall_s": {n: r["wall_s"] for n, r in runs.items()},
           "launches": total}
    res["ok"] = bool(pre["ok"] and resume["ok"] and quarantine["ok"]
                     and keep["ok"] and fault["ok"] and saves["ok"]
                     and finetune["ok"] and pad["ok"] and prec["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("checkpoint phase failed")
    return res


# ------------------------------------------------------------ phase 12

# the Python API: Inception-BN.conf's net and globals through
# cxxnet_tpu_torch.wrapper.Net on the card, NCHW float32 arrays at its
# edge; the train knobs for the updates and the eval fold for predict
WRAP_UPDATES = 3
WRAP_ROWS = 4
WRAP_KNOBS = [("bn_pallas", "1")] + KNOBS


def wrapper_cfg_text(workdir: str) -> str:
    """Inception-BN.conf's netconfig and globals (its iterator blocks
    dropped) as config text, as a user hands ``Net``."""
    from cxxnet_tpu_torch.utils.config import (parse_config_file,
                                               split_sections)
    conf = shipped_conf(workdir, "Inception-BN.conf",
                        os.path.join(workdir, "train.rec"),
                        os.path.join(workdir, "val.rec"))
    _, global_cfg = split_sections(parse_config_file(conf))
    return "".join("%s = %s\n" % kv for kv in global_cfg)


def phase_wrapper(workdir: str):
    """``Net(dev="gpu")`` from Inception-BN.conf's text (batch 128,
    3x224x224, bf16): ``WRAP_UPDATES`` updates on seeded NCHW arrays
    (each 69 + 69 bf16 bn_apply and 1 bias_grad_bf16 launches),
    ``evaluate`` over val.rec, ``predict`` and ``extract`` of 4 rows
    (69 bf16 conv_epilogue launches a forward) against the port on the
    CPU from the net's snapshot (the cli phase's bf16 tolerances) and
    ``predict`` against ``NetTrainer.predict`` on the card from that
    snapshot (the same bits); the snapshot loaded into a second Net
    gives the same ``get_weight`` bits. The monitor keys ride along
    (``monitor = jsonl``: one ``step`` record an update)."""
    import torch
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config
    from cxxnet_tpu_torch.wrapper import DataIter, Net
    val_rec = os.path.join(workdir, "val.rec")
    if not os.path.exists(val_rec):
        write_cli_archives(workdir)
    text = wrapper_cfg_text(workdir)
    dev = "gpu" if DEVICE == "cuda" else DEVICE
    stream_path = os.path.join(workdir, "wrapper.jsonl")
    rng = np.random.RandomState(SEED + 12)
    x = images(rng, TRAIN_BATCH)
    if x.shape[1] != CKPT_CROP:
        x = np.ascontiguousarray(x[:, :CKPT_CROP, :CKPT_CROP])
    xn = np.ascontiguousarray(x.transpose(0, 3, 1, 2))       # NCHW
    y = rng.randint(0, NCLASS, TRAIN_BATCH).astype(np.float32)
    # the conf's eval block over val.rec
    ev = DataIter("iter = imgrec\npath_imgrec = %s\ninput_shape = 3,%d,%d"
                  "\niter = end\nbatch_size = %d\n"
                  % (val_rec, CKPT_CROP, CKPT_CROP, TRAIN_BATCH))
    # the main path, its launch counts from 0
    kernels.reset_launch_counts()
    t_all = time.perf_counter()
    net = Net(dev=dev, cfg=text)
    for k, v in WRAP_KNOBS + [("monitor", "jsonl"),
                              ("monitor_path", stream_path)]:
        net.set_param(k, v)
    net.init_model()
    updates = []
    for i in range(WRAP_UPDATES):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        net.start_round(i)
        net.update(xn, y)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        updates.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "launches": {k: after[k] - before[k]
                                     for k in after}})
    metric = net.evaluate(ev, "val")
    before = kernels.launch_counts()
    pred4 = net.predict(xn[:WRAP_ROWS])
    mid = kernels.launch_counts()
    top4 = net.extract(xn[:WRAP_ROWS], "top")
    flat4 = net.extract(xn[:WRAP_ROWS], "flat")
    after = kernels.launch_counts()
    launches = dict(after)
    wall_s = time.perf_counter() - t_all
    snap = os.path.join(workdir, "wrapper.model.npz")
    net.save_model(snap)
    net.close()
    ev.close()
    # comparisons: their launches are not the main path's
    cfg = parse_config(text) + WRAP_KNOBS
    card = NetTrainer(cfg, device=DEVICE)
    card.load_model(snap)
    card_pred = card.predict(DataBatch(x[:WRAP_ROWS]))
    del card
    kernels.restore_launch_counts(launches)
    cpu = NetTrainer(cfg, device="cpu")
    cpu.load_model(snap)
    ref_top = cpu.extract_feature(DataBatch(x[:WRAP_ROWS]), "top")
    ref_flat = cpu.extract_feature(DataBatch(x[:WRAP_ROWS]), "flat")
    del cpu
    kernels.restore_launch_counts(launches)
    net2 = Net(dev=dev, cfg=text)
    for k, v in WRAP_KNOBS:
        net2.set_param(k, v)
    net2.load_model(snap)
    weights = [(lk, tag) for lk, tags in net._trainer.params.items()
               for tag in tags if tag in ("wmat", "bias")]
    same_weights = all(same_bits(net.get_weight(lk, tag),
                                 net2.get_weight(lk, tag))
                       for lk, tag in weights)
    del net, net2
    kernels.restore_launch_counts(launches)
    top = top4.reshape(WRAP_ROWS, -1)
    flat = flat4.reshape(WRAP_ROWS, -1)
    ref_flat = ref_flat.reshape(WRAP_ROWS, -1)
    scale = float(np.abs(ref_flat).max())
    flat_err = np.abs(flat - ref_flat)
    cpu_rows = rows_vs_cpu(top, ref_top.reshape(WRAP_ROWS, -1),
                           BF16_CPU_ATOL, BF16_CPU_RTOL)
    decided = np.array(cpu_rows["top1_decided"])
    recs = read_jsonl(stream_path) if os.path.exists(stream_path) else []
    steps = [r for r in recs if r["event"] == "step"]
    m = re.search(r"val-error:(\S+)", metric)
    res = {
        "phase": "wrapper", "model": "Inception-BN.conf",
        "config": "cxxnet_tpu_torch.wrapper.Net(dev=%r) from "
                  "Inception-BN.conf's netconfig and globals (batch %d, "
                  "3x%dx%d, %d classes, dtype = bfloat16), %s; seeded "
                  "NCHW float32 inputs" % (dev, TRAIN_BATCH, CKPT_CROP,
                                           CKPT_CROP, NCLASS,
                                           ", ".join("%s = %s" % kv
                                                     for kv in WRAP_KNOBS)),
        "wall_s": wall_s,
        "update_ms": [u["ms"] for u in updates],
        "update_launches": [u["launches"] for u in updates],
        "expected_per_update": CLI_TRAIN_LAUNCHES,
        "predict_launches": {k: mid[k] - before[k] for k in mid},
        "expected_per_forward": CLI_PRED_LAUNCHES,
        "launches": launches,
        "metric": metric,
        "metric_finite": bool(m and np.isfinite(float(m.group(1)))),
        "predict": pred4.tolist(),
        "predict_same_bits_as_trainer": same_bits(pred4, card_pred),
        "cpu": cpu_rows,
        "predict_vs_cpu": bool(np.all(
            (pred4 == ref_top.reshape(WRAP_ROWS, -1).argmax(1))
            | ~decided)),
        "flat_cpu": {"max_abs_err": float(flat_err.max()), "scale": scale,
                     "close": bool(np.all(flat_err <= BF16_CPU_RTOL
                                          * np.abs(ref_flat)
                                          + 1e-3 * scale))},
        "weights_compared": len(weights),
        "save_load_same_bits": bool(same_weights and weights),
        "stream": {"records": len(recs),
                   "schema_errors": validate_records(recs,
                                                     strict=False)[:5],
                   "steps": [r["step"] for r in steps]}}
    res["counted"] = bool(
        all(u["launches"] == CLI_TRAIN_LAUNCHES for u in updates)
        and res["predict_launches"] == CLI_PRED_LAUNCHES)
    res["ok"] = bool(
        res["counted"] and res["metric_finite"]
        and res["predict_same_bits_as_trainer"] and cpu_rows["close"]
        and res["predict_vs_cpu"] and res["flat_cpu"]["close"]
        and res["save_load_same_bits"]
        and not res["stream"]["schema_errors"]
        and res["stream"]["steps"] == list(range(1, WRAP_UPDATES + 1)))
    torch.cuda.empty_cache()
    emit(res)
    if not res["ok"]:
        raise RuntimeError("wrapper phase failed")
    return res


FLEET_POOL = 48                # seeded 224x224 images the clients draw from
FLEET_PRE = 100                # ok requests before the new snapshot commits
FLEET_POST = 150               # ok requests after the flip before the stop
FLEET_QUOTA = "free:1:1"       # the over-quota tenant: 1 row/s, burst 1
FLEET_HTTP_STARTS = 8          # HTTP bodies: rows from the pool's first 8
FLEET_V2_DEPTH = 8             # CXN2 requests each v2 client keeps in flight
FLEET_BINARY_S = 4.0           # the binary-only window after the main path
FLEET_LAUNCHES = BF16_LAUNCHES  # per served forward (serve_dtype from dtype)
FLEET_TIMEOUT_S = 600          # a client process's limit


def fleet_cfg(workdir: str):
    """Inception-BN.conf's netconfig and globals (batch 128, bf16) with
    the eval fold, as every served session of the fleet phase reads
    them: the conf's bucket ladder (``auto``: 1, 2, 4, ..., 128)."""
    from cxxnet_tpu_torch.utils.config import parse_config
    return parse_config(wrapper_cfg_text(workdir)) + KNOBS + [
        ("serve_max_delay_ms", "2"), ("serve_queue_rows", "4096")]


def perturbed_snapshot(src: str, dst: str, seed: int = SEED + 13):
    """A newer snapshot through the port's checkpoint layer: every
    parameter times (1 + 0.02 N(0, 1)), seeded."""
    from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot, write_snapshot
    arrays, meta = read_snapshot(src)
    rng = np.random.RandomState(seed)
    for k in sorted(arrays):
        if k.startswith("param/"):
            a = arrays[k]
            arrays[k] = (a * (1 + 0.02 * rng.randn(*a.shape))).astype(
                a.dtype)
    meta = {k: v for k, v in meta.items() if k != "content_digest"}
    write_snapshot(dst, arrays, meta)


def _http_json(port: int, body: str, timeout: float = 300.0):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/predict", body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read()), dict(r.getheaders())
    finally:
        conn.close()


def _commit_and_flip(ok_count, errors, swap):
    """The hot-swap under traffic: ``FLEET_PRE`` ok requests, then the
    perturbed snapshot commits (``os.replace`` of the staged file into
    the watched directory, as ``write_snapshot`` commits); the flip,
    whose time the server's process writes to ``swap["flip"]`` when its
    ``hot_swap`` record comes; then ``FLEET_POST`` ok requests sent after
    it. Returns the commit's and the flip's times (the flip None if it
    never came)."""
    deadline = time.monotonic() + 300
    while ok_count() < FLEET_PRE and time.monotonic() < deadline \
            and not errors:
        time.sleep(0.02)
    t_commit, t_swap = time.time(), None
    os.replace(swap["staged"], swap["commit"])
    while time.monotonic() < deadline and not errors:
        if os.path.exists(swap["flip"]):
            with open(swap["flip"]) as f:
                t_swap = float(f.read())
            break
        time.sleep(0.02)
    while t_swap is not None and ok_count(t_swap) < FLEET_POST \
            and time.monotonic() < deadline and not errors:
        time.sleep(0.02)
    return t_commit, t_swap


def fleet_traffic(ports, pool, swap=None, http: bool = True,
                  seconds: float = 0.0, until: str = "",
                  model: str = "main", started: str = "",
                  max_rows: int = 16, v2_depth: int = FLEET_V2_DEPTH):
    """Concurrent clients of the fleet at ``ports`` (HTTP, binary): 2
    HTTP (1-2 rows) and the over-quota tenant's HTTP client unless
    ``http`` is False, 2 CXN1 (1-16 rows) and 2 CXN2 (1-16 rows,
    ``FLEET_V2_DEPTH`` in flight). With ``swap`` (the staged snapshot,
    its committed name and the flip file): after ``FLEET_PRE`` ok
    requests the snapshot commits into the watched directory, and the
    drive stops ``FLEET_POST`` ok requests after the flip; without, it
    runs ``seconds``, or until the file ``until`` exists when one is
    named. ``model`` is the routed model the clients ask for; the
    file ``started``, when named, is written at the first ok reply; the
    binary requests carry 1 to ``max_rows`` rows, CXN2 ``v2_depth`` in
    flight.
    Returns every request's record and the times of the commit and the
    flip. Runs in :func:`fleet_clients`' process."""
    import socket
    import threading
    from cxxnet_tpu_torch.serve.frontend import (BinaryClient,
                                                 pack_request_v2,
                                                 read_reply_tagged)
    http_port, binary_port = ports
    stop = threading.Event()
    lock = threading.Lock()
    log = []
    errors = []
    elems = int(np.prod(pool.shape[1:]))
    flat = pool.reshape(pool.shape[0], elems)
    # the HTTP bodies, encoded before the drive: 150,528 floats a row
    bodies = {(s, n, tenant): json.dumps(
        {"model": model, "tenant": tenant,
         "rows": flat[s:s + n].tolist()})
        for s in range(FLEET_HTTP_STARTS) for n in (1, 2)
        for tenant in ("gold", "free")
        if http and (tenant == "gold" or n == 1)}

    def note(proto, tenant, start, n, status, result, t_send, extra=None):
        with lock:
            log.append({"proto": proto, "tenant": tenant, "start": start,
                        "n": n, "status": status, "result": result,
                        "t_send": t_send,
                        "ms": (time.time() - t_send) * 1e3,
                        "extra": extra})
            if started and status == "ok" and not os.path.exists(started):
                with open(started, "w") as f:
                    f.write(repr(t_send))

    def guarded(fn):
        def run(*a):
            try:
                fn(*a)
            except Exception as e:              # surfaced by the checks
                with lock:
                    errors.append("%s: %s" % (type(e).__name__, e))
        return run

    def http_client(ci):
        rng = np.random.RandomState(SEED + 20 + ci)
        while not stop.is_set():
            n = int(rng.randint(1, 3))
            s = int(rng.randint(0, FLEET_HTTP_STARTS))
            t = time.time()
            code, body, hdr = _http_json(http_port, bodies[(s, n, "gold")])
            res = np.asarray(body["result"], np.float32) if code == 200 \
                else body
            note("http", "gold", s, n, "ok" if code == 200 else code, res,
                 t)

    def v1_client(ci):
        rng = np.random.RandomState(SEED + 30 + ci)
        bc = BinaryClient("127.0.0.1", binary_port, timeout=300)
        try:
            while not stop.is_set():
                n = int(rng.randint(1, max_rows + 1))
                s = int(rng.randint(0, len(pool) - n + 1))
                t = time.time()
                st, res = bc.predict(flat[s:s + n], model=model,
                                     tenant="team-%d" % ci)
                note("cxn1", "team-%d" % ci, s, n, st, res, t)
        finally:
            bc.close()

    def v2_client(ci):
        rng = np.random.RandomState(SEED + 40 + ci)
        sock = socket.create_connection(("127.0.0.1", binary_port),
                                        timeout=300)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rfile = sock.makefile("rb")
        corr = 0
        try:
            while not stop.is_set():
                sent = {}
                for _ in range(v2_depth):
                    n = int(rng.randint(1, max_rows + 1))
                    s = int(rng.randint(0, len(pool) - n + 1))
                    sent[corr] = (s, n, time.time())
                    sock.sendall(pack_request_v2(corr, model, "",
                                                 flat[s:s + n]))
                    corr += 1
                for _ in range(v2_depth):
                    c, st, res = read_reply_tagged(rfile)
                    s, n, t = sent.pop(c)
                    note("cxn2", "", s, n, st, res, t)
        finally:
            rfile.close()
            sock.close()

    def free_client():
        while not stop.is_set():
            t = time.time()
            code, body, hdr = _http_json(http_port, bodies[(0, 1, "free")])
            res = np.asarray(body["result"], np.float32) if code == 200 \
                else body
            note("http", "free", 0, 1, "ok" if code == 200 else code, res,
                 t, extra=hdr.get("Retry-After"))
            time.sleep(0.01)

    def ok_count(after=0.0):
        with lock:
            return sum(1 for r in log if r["status"] == "ok"
                       and r["tenant"] != "free" and r["t_send"] >= after)

    kinds = (http_client, v1_client, v2_client) if http \
        else (v1_client, v2_client)
    threads = [threading.Thread(target=guarded(f), args=(i,))
               for f in kinds for i in range(2)]
    if http:
        threads.append(threading.Thread(target=guarded(free_client)))
    t0 = time.time()
    for t in threads:
        t.start()
    t_commit = t_swap = None
    try:
        if swap is None:
            deadline = time.monotonic() + seconds
            while time.monotonic() < deadline \
                    and not (until and os.path.exists(until)):
                time.sleep(0.02)
        else:
            t_commit, t_swap = _commit_and_flip(ok_count, errors, swap)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
        t_end = time.time()
    return {"log": log, "errors": errors, "t0": t0, "t_end": t_end,
            "t_commit": t_commit, "t_swap": t_swap,
            "alive": sum(t.is_alive() for t in threads)}


def fleet_clients(argv) -> int:
    """The fleet phase's clients in a process of their own, so that
    nothing of theirs takes the server's interpreter lock: reads the
    spec ``argv[0]`` (ports, or a ``port_file`` to wait for; the pool's
    ``.npy``, ``swap``, ``http``, ``seconds``, ``until``, ``model``,
    ``out``), runs :func:`fleet_traffic` (or, given ``failover``
    endpoints, :func:`door_traffic`) and writes its log to
    ``<out>.json`` and the ok replies' rows, in log order, to
    ``<out>.npy``."""
    with open(argv[0]) as f:
        spec = json.load(f)
    if spec.get("port_file"):
        # a server that boots later (the continual loop's fleet starts
        # after its first generation)
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while not os.path.exists(spec["port_file"]):
            if time.monotonic() > deadline:
                raise RuntimeError("no port file %s" % spec["port_file"])
            time.sleep(0.05)
        with open(spec["port_file"]) as f:
            ports = json.load(f)
        spec.update(http_port=ports["http_port"],
                    binary_port=ports["binary_port"])
    pool = np.load(spec["pool"])
    if spec.get("failover"):
        drive = door_traffic([tuple(e) for e in spec["failover"]], pool,
                             until=spec["until"], model=spec["model"],
                             started=spec.get("started", ""))
    else:
        drive = fleet_traffic((spec["http_port"], spec["binary_port"]), pool,
                              swap=spec["swap"], http=spec["http"],
                              seconds=spec["seconds"],
                              until=spec.get("until", ""),
                              model=spec.get("model", "main"),
                              started=spec.get("started", ""),
                              max_rows=spec.get("max_rows", 16),
                              v2_depth=spec.get("v2_depth", FLEET_V2_DEPTH))
    rows = []
    for r in drive["log"]:
        if r["status"] == "ok":
            rows.append(np.asarray(r["result"], np.float32)
                        .reshape(r["n"], -1))
            r["result"] = None
        elif not isinstance(r["result"], (dict, str)):
            r["result"] = str(r["result"])
    np.save(spec["out"] + ".npy", np.concatenate(rows) if rows
            else np.zeros((0, 1), np.float32))
    with open(spec["out"] + ".json", "w") as f:
        json.dump(drive, f)
    return 0


def start_clients(workdir: str, tag: str, spec):
    """Start :func:`fleet_clients` in a subprocess with ``spec`` (its
    ``out`` set from ``tag``); :func:`finish_clients` collects it."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(workdir, tag)
    spec = dict(spec, out=out)
    with open(out + ".spec.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH", "")) if p))
    cmd = [sys.executable, "-c", "import sys, chip_smoke; "
           "sys.exit(chip_smoke.fleet_clients(sys.argv[1:]))",
           out + ".spec.json"]
    err = open(out + ".stderr.txt", "w")
    p = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=err, stderr=err)
    return {"p": p, "out": out, "err": err, "tag": tag}


def finish_clients(cl, poll=None):
    """Wait for the clients' process (``poll()`` runs every 20 ms
    meanwhile), kill it past ``FLEET_TIMEOUT_S``, and return its drive,
    every ok record's ``result`` its rows."""
    p, out = cl["p"], cl["out"]
    try:
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while p.poll() is None and time.monotonic() < deadline:
            if poll is not None:
                poll()
            time.sleep(0.02)
        rc = p.poll()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        cl["err"].close()
    if rc != 0:
        with open(out + ".stderr.txt") as f:
            raise RuntimeError("fleet clients (%s) exited with %s: %s"
                               % (cl["tag"], rc, f.read()[-2000:]))
    with open(out + ".json") as f:
        drive = json.load(f)
    rows = np.load(out + ".npy")
    at = 0
    for r in drive["log"]:
        if r["status"] == "ok":
            r["result"] = rows[at:at + r["n"]]
            at += r["n"]
    return drive


def drive_fleet(fleet, sink, workdir: str, tag: str, pool_path: str,
                swap=None, http: bool = True, seconds: float = 0.0,
                until: str = ""):
    """Run :func:`fleet_clients` in a subprocess against the fleet's
    ports and return its drive, every ok record's ``result`` its rows.
    With ``swap``, this process writes the ``hot_swap`` record's time to
    ``swap["flip"]`` when the record comes."""
    cl = start_clients(workdir, tag, {
        "http_port": fleet.http_port, "binary_port": fleet.binary_port,
        "pool": pool_path, "swap": swap, "http": http,
        "seconds": seconds, "until": until})

    def note_flip():
        if swap is not None and not os.path.exists(swap["flip"]):
            swaps = [r for r in sink.records if r["event"] == "hot_swap"]
            if swaps:
                with open(swap["flip"] + ".tmp", "w") as f:
                    f.write(repr(swaps[0]["t"]))
                os.replace(swap["flip"] + ".tmp", swap["flip"])

    return finish_clients(cl, note_flip)


def bucket_refs(sess, pool, ladder):
    """``{bucket: rows}``: each pool image's row as ``sess`` answers it
    in a batch of exactly that bucket (the pool in slices of the
    bucket's rows, the last padded with zeros)."""
    out = {}
    for b in ladder:
        parts = []
        for i in range(0, len(pool), b):
            chunk = pool[i:i + b]
            k = len(chunk)
            if k < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - k,) + pool.shape[1:], pool.dtype)])
            parts.append(np.asarray(sess.predict(chunk))[:k]
                         .reshape(k, -1))
        out[b] = np.concatenate(parts)
    return out


def batch_stats(records, t0: float, t1: float):
    """The micro-batches the fleet's batcher dispatched between ``t0``
    and ``t1`` (the records' clock): how many, their rows, how many of
    each bucket, the dispatch thread's time each (forward and result
    fetch: ``device_ms``; also its median per bucket) and the oldest
    request's queue wait at batch form."""
    bats = [r for r in records if r["event"] == "serve_batch"
            and t0 <= r["t"] <= t1]
    if not bats:
        return {"batches": 0}
    disp = np.array([r["device_ms"] for r in bats])
    queue = np.array([r["queue_ms"] for r in bats])
    return {"batches": len(bats), "per_s": len(bats) / (t1 - t0),
            "rows_mean": float(np.mean([r["rows"] for r in bats])),
            "buckets": {str(b): sum(r["bucket"] == b for r in bats)
                        for b in sorted({r["bucket"] for r in bats})},
            "dispatch_ms_p50": float(np.percentile(disp, 50)),
            "dispatch_ms_p90": float(np.percentile(disp, 90)),
            "dispatch_ms_p50_by_bucket": {
                str(b): float(np.percentile(
                    [r["device_ms"] for r in bats if r["bucket"] == b], 50))
                for b in sorted({r["bucket"] for r in bats})},
            "dispatch_busy_share": float(disp.sum() / 1e3 / (t1 - t0)),
            "queue_ms_p50": float(np.percentile(queue, 50))}


def proto_stats(log, wall: float, protocols):
    """Per protocol: ok requests and rows, rows/s over ``wall``, and the
    p50 / p90 of the clients' request times (ms)."""
    out = {}
    for proto in protocols:
        rs = [r for r in log if r["proto"] == proto and r["status"] == "ok"]
        ms = np.array([r["ms"] for r in rs]) if rs else np.zeros(1)
        out[proto] = {
            "requests": len(rs), "rows": int(sum(r["n"] for r in rs)),
            "rows_per_s": sum(r["n"] for r in rs) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90))}
    return out


def phase_fleet(workdir: str):
    """``task = serve_fleet``'s ``FleetServer`` on the card over
    Inception-BN.conf's net (bf16, the eval fold, the conf's bucket
    ladder up to 128), booted from the wrapper phase's snapshot copied
    into a fresh model_dir (``0001.model.npz``): concurrent HTTP, CXN1
    and CXN2 traffic from a client process of its own (:func:`drive_fleet`)
    with a hot-swap to a perturbed snapshot mid-drive (no failed request;
    each reply the bits of a ``ServeSession`` on the snapshot that
    served it, in a batch of a bucket that could hold it: rows do not
    depend on their batch-mates, but their bits do on the bucket's shape;
    every reply sent after the flip the new one's), batches of 128 rows
    among the drive's, the over-quota tenant's typed 429s with
    ``Retry-After``, exactly 69 bf16 conv_epilogue launches a served
    forward and no other kernel, ``serve_device_mem_budget`` rejecting a
    second model at the router and an over-budget model at its engine
    while the first keeps serving, and a schema-valid record stream.
    Rows/s and latency percentiles per protocol are printed, with no
    limit, for the drive and for a ``FLEET_BINARY_S`` window of the
    binary clients alone afterwards (no HTTP body parse in the server)."""
    import torch
    from cxxnet_tpu_torch.artifact import ResidencyBudgetError
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.monitor.schema import validate_records
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import BinaryClient, FleetServer, ServeSession
    from cxxnet_tpu_torch.serve.router import session_resident_bytes
    src = os.path.join(workdir, "wrapper.model.npz")
    if not os.path.exists(src):
        raise RuntimeError("fleet: the wrapper phase's snapshot is missing")
    mdir = os.path.join(workdir, "fleet_models")
    os.makedirs(mdir)
    snap1 = os.path.join(mdir, "0001.model.npz")
    snap2 = os.path.join(mdir, "0002.model.npz")
    staged = os.path.join(workdir, "fleet_staged.model.npz")
    cfg = fleet_cfg(workdir)
    rng = np.random.RandomState(SEED + 14)
    pool = images(rng, FLEET_POOL)
    if pool.shape[1] != CKPT_CROP:
        pool = np.ascontiguousarray(pool[:, :CKPT_CROP, :CKPT_CROP])
    pool_path = os.path.join(workdir, "fleet_pool.npy")
    np.save(pool_path, pool)
    # three updates leave the running BN statistics near zero and the
    # softmax rows saturated (one class at probability 1), which would
    # hide which snapshot answered: the BNs get the pool's moments, as
    # the serve phase calibrates them, and the snapshot is saved anew
    cal = NetTrainer(cfg, device=DEVICE)
    cal.load_model(src)
    calibrate_bn(cal, cal.to_device_batch(pool[:32]))
    cal.save_model(snap1)
    del cal
    # the newer snapshot, written before the drive and committed into
    # the watched directory during it
    perturbed_snapshot(snap1, staged)
    # the comparison session on the first snapshot, before the main path
    ref1 = ServeSession(cfg, model_path=snap1, device=DEVICE)
    resident = session_resident_bytes(ref1)
    budget_mb = 1.5 * resident / 1e6
    rec = recorder()
    fcfg = cfg + [("serve_models", "main=%s" % mdir),
                  ("serve_http_port", "0"), ("serve_binary_port", "0"),
                  ("serve_swap_poll_s", "0.2"), ("serve_quota", FLEET_QUOTA),
                  ("serve_device_mem_budget", "%.6f" % budget_mb)]
    # the main path, its launch counts from 0
    kernels.reset_launch_counts()
    t_boot = time.perf_counter()
    fleet = FleetServer(fcfg, monitor=rec, device=DEVICE)
    try:
        fleet.start()
        boot_s = time.perf_counter() - t_boot
        s1 = fleet.router.resolve("main").session
        ladder = tuple(s1.engine.buckets)
        drive = drive_fleet(fleet, rec.sink, workdir, "fleet_drive",
                            pool_path, swap={
                                "staged": staged, "commit": snap2,
                                "flip": os.path.join(workdir, "fleet_flip")})
        torch.cuda.synchronize()
        entry = fleet.router.resolve("main")
        s2 = entry.session
        forwards = sum(s.warmup_programs
                       + s.engine.counters_snapshot()["dispatches"]
                       for s in {id(s1): s1, id(s2): s2}.values())
        launches = kernels.launch_counts()
        swaps = [r for r in rec.sink.records if r["event"] == "hot_swap"]
        # comparisons: their launches are not the main path's
        ref2 = ServeSession(cfg, model_path=snap2, device=DEVICE)
        refs = {1: bucket_refs(ref1, pool, ladder),
                2: bucket_refs(ref2, pool, ladder)}
        # the two snapshots must answer apart, or the attribution below
        # tells nothing; the buckets whose bits agree (one group per
        # distinct set of bits) say how far the bucket is pinned
        distinct = not same_bits(refs[1][16], refs[2][16])
        groups = []
        for bk in ladder:
            for grp in groups:
                if same_bits(refs[1][grp[0]], refs[1][bk]):
                    grp.append(bk)
                    break
            else:
                groups.append([bk])
        served = {"old": 0, "new": 0, "neither": 0, "late_old": 0}
        by_bucket = {}
        worst = 0.0
        for r in drive["log"]:
            if r["status"] != "ok":
                continue
            n, st = r["n"], r["start"]
            got = np.asarray(r["result"]).reshape(n, -1)
            cands = [(snap, bk) for snap in (1, 2) for bk in ladder
                     if bk >= n]
            hit = next(((snap, bk) for snap, bk in cands
                        if same_bits(got, refs[snap][bk][st:st + n])), None)
            if hit is None:
                served["neither"] += 1
                worst = max(worst, min(
                    float(np.abs(got - refs[snap][bk][st:st + n]).max())
                    for snap, bk in cands))
                continue
            served["old" if hit[0] == 1 else "new"] += 1
            by_bucket[hit[1]] = by_bucket.get(hit[1], 0) + 1
            if hit[0] == 1 and drive["t_swap"] is not None \
                    and r["t_send"] >= drive["t_swap"]:
                served["late_old"] += 1
        # serve_device_mem_budget: a second model at the router, and an
        # engine whose own model passes the budget
        try:
            fleet.router.register("second", ref2, 2, snap2)
            router_budget = "registered"
        except ResidencyBudgetError as e:
            router_budget = "ResidencyBudgetError: %s" % e
        try:
            ServeSession(cfg + [("serve_device_mem_budget",
                                 "%.6f" % (0.5 * resident / 1e6))],
                         model_path=snap1, device=DEVICE).close()
            engine_budget = "built"
        except ResidencyBudgetError as e:
            engine_budget = "ResidencyBudgetError: %s" % e
        bc = BinaryClient("127.0.0.1", fleet.binary_port, timeout=300)
        try:
            st, after = bc.predict(pool[:3].reshape(3, -1), model="main")
        finally:
            bc.close()
        # the binary protocols alone: no JSON body parse in the server
        quiet = drive_fleet(fleet, rec.sink, workdir, "fleet_binary",
                            pool_path, http=False, seconds=FLEET_BINARY_S)
        still_serving = st == "ok" and same_bits(
            np.asarray(after).reshape(3, -1), refs[2][4][:3])
        models = fleet.router.ids()
        summary = fleet.close()
    finally:
        fleet.close(drain=False)
    for s in (ref1, ref2):
        s.close()
    kernels.restore_launch_counts(launches)
    log = drive["log"]
    mine = [r for r in log if r["tenant"] != "free"]
    free = [r for r in log if r["tenant"] == "free"]
    failed = [(r["proto"], r["status"], str(r["result"])[:200])
              for r in mine if r["status"] != "ok"]
    shed = [r for r in free if r["status"] == 429]
    wall = drive["t_end"] - drive["t0"]
    by_proto = proto_stats(mine, wall, ("http", "cxn1", "cxn2"))
    quiet_failed = [r for r in quiet["log"] if r["status"] != "ok"]
    binary_only = proto_stats(quiet["log"], quiet["t_end"] - quiet["t0"],
                              ("cxn1", "cxn2"))
    drive_batches = batch_stats(rec.sink.records, drive["t0"],
                                drive["t_end"])
    expected = {k: v * forwards for k, v in FLEET_LAUNCHES.items()}
    schema_errors = validate_records(rec.sink.records, strict=False)
    res = {
        "phase": "fleet", "model": "Inception-BN.conf",
        "config": "FleetServer (task = serve_fleet's core) over "
                  "Inception-BN.conf's net, dtype = bfloat16, %s, buckets "
                  "%s, serve_max_delay_ms = 2, serve_swap_poll_s = 0.2, "
                  "serve_quota = %s, serve_device_mem_budget = 1.5x one "
                  "model's resident bytes; %d seeded 224x224 images; the "
                  "clients in a process of their own"
                  % (", ".join("%s = %s" % kv for kv in KNOBS),
                     ",".join(map(str, ladder)), FLEET_QUOTA, FLEET_POOL),
        "boot_s": boot_s, "wall_s": wall,
        "requests": len(mine), "failed": failed[:10],
        "n_failed": len(failed), "client_errors": drive["errors"][:5],
        "threads_alive": drive["alive"],
        "by_protocol": by_proto, "binary_only": binary_only,
        # the drive in three windows: before the commit, while the
        # shadow session builds and warms (it shares the interpreter),
        # and after the flip
        "batches": {"drive": drive_batches,
                    "before_commit": batch_stats(
                        rec.sink.records, drive["t0"],
                        drive["t_commit"] or drive["t_end"]),
                    "shadow_build": batch_stats(
                        rec.sink.records, drive["t_commit"] or drive["t0"],
                        drive["t_swap"] or drive["t_end"]),
                    "after_flip": batch_stats(
                        rec.sink.records, drive["t_swap"] or drive["t_end"],
                        drive["t_end"]),
                    "binary_only": batch_stats(rec.sink.records,
                                               quiet["t0"],
                                               quiet["t_end"])},
        "binary_only_failed": len(quiet_failed) + len(quiet["errors"]),
        "hot_swaps": [{k: r[k] for k in ("old_counter", "new_counter",
                                         "warmup_programs", "old_requests",
                                         "wall_ms")} for r in swaps],
        "commit_to_flip_s": (drive["t_swap"] - drive["t_commit"])
        if drive["t_swap"] else None,
        "snapshots_distinct": distinct, "served_by": served,
        "bucket_bit_groups": groups,
        "matched_at_bucket": {str(k): v for k, v in sorted(by_bucket.items())},
        "worst_mismatch": worst,
        "quota": {"free_requests": len(free), "over_quota_429": len(shed),
                  "typed": all(r["result"].get("error") == "over_quota"
                               and r["extra"] for r in shed),
                  "free_other": [(r["status"], str(r["result"])[:120])
                                 for r in free
                                 if r["status"] not in ("ok", 429)][:5]},
        "resident_bytes": resident, "budget_mb": budget_mb,
        "router_budget": router_budget, "engine_budget": engine_budget,
        "still_serving": still_serving, "models_after": models,
        "forwards": forwards, "launches": launches,
        "expected_per_forward": FLEET_LAUNCHES,
        "summary_errors": summary["requests"]["error"]
        + summary["requests"]["closed"],
        "records": len(rec.sink.records),
        "schema_errors": schema_errors[:5]}
    top = ladder[-1]
    res["top_bucket_batches"] = drive_batches.get("buckets", {}).get(
        str(top), 0)
    res["counted"] = launches == expected and forwards > 0
    res["ok"] = bool(
        res["counted"] and not failed and not drive["errors"]
        and not drive["alive"] and len(swaps) == 1
        and swaps[0]["new_counter"] == 2 and distinct
        and served["neither"] == 0
        and served["late_old"] == 0 and served["old"] > 0
        and served["new"] > 0 and top == 128
        and res["top_bucket_batches"] > 0 and shed and res["quota"]["typed"]
        and not res["quota"]["free_other"]
        and router_budget.startswith("ResidencyBudgetError")
        and engine_budget.startswith("ResidencyBudgetError")
        and still_serving and models == ["main"]
        and res["summary_errors"] == 0 and not schema_errors
        and all(p["requests"] > 0 for p in by_proto.values())
        and not res["binary_only_failed"] and not quiet["alive"])
    torch.cuda.empty_cache()
    emit(res)
    if not res["ok"]:
        raise RuntimeError("fleet phase failed")
    return res


CAPI_UPDATES = 3
CAPI_ROWS = 4

C_HOST = r"""
#include "cxxnet_wrapper.h"
#include <stdio.h>
#include <stdlib.h>

/* host <cfg file> <device> <model> <rows file: n x c x h x w f32> n c h w
 *      <out file: the "top" node's rows, f32> */
static char *slurp(const char *path, long *len) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  *len = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = (char *)malloc(*len + 1);
  if (fread(buf, 1, *len, f) != (size_t)*len) { fclose(f); return NULL; }
  buf[*len] = 0;
  fclose(f);
  return buf;
}

int main(int argc, char **argv) {
  if (argc != 10) return 64;
  long n_cfg = 0, n_rows = 0;
  char *cfg = slurp(argv[1], &n_cfg);
  float *rows = (float *)slurp(argv[4], &n_rows);
  if (!cfg || !rows) return 65;
  cxn_uint n = (cxn_uint)atoi(argv[5]);
  cxn_uint dshape[4] = {n, (cxn_uint)atoi(argv[6]), (cxn_uint)atoi(argv[7]),
                        (cxn_uint)atoi(argv[8])};
  void *net = CXNNetCreate(argv[2], cfg);
  if (!net) { fprintf(stderr, "create: %s\n", CXNGetLastError()); return 1; }
  CXNNetSetParam(net, "bn_pallas", "1");
  CXNNetSetParam(net, "bn_fold_eval", "1");
  CXNNetSetParam(net, "bn_fuse_relu", "1");
  CXNNetSetParam(net, "conv_pallas_epilogue", "1");
  CXNNetLoadModel(net, argv[3]);
  cxn_uint osize = 0;
  const cxn_real_t *pred = CXNNetPredictBatch(net, rows, dshape, &osize);
  if (!pred || osize != n) {
    fprintf(stderr, "predict: %s\n", CXNGetLastError());
    return 2;
  }
  printf("C-ABI-OK preds=");
  for (cxn_uint i = 0; i < osize; ++i) printf("%s%d", i ? "," : "", (int)pred[i]);
  cxn_uint oshape[4] = {0, 0, 0, 0};
  const cxn_real_t *top = CXNNetExtractBatch(net, rows, dshape, "top", oshape);
  if (!top) {
    fprintf(stderr, "extract: %s\n", CXNGetLastError());
    return 3;
  }
  size_t count = (size_t)oshape[0] * oshape[1] * oshape[2] * oshape[3];
  FILE *out = fopen(argv[9], "wb");
  if (!out || fwrite(top, sizeof(cxn_real_t), count, out) != count) return 4;
  fclose(out);
  printf(" top=%u,%u,%u,%u\n", oshape[0], oshape[1], oshape[2], oshape[3]);
  CXNNetFree(net);
  return 0;
}
"""


class CNet:
    """One ``CXNNet*`` handle of the port's C ABI through ctypes."""

    def __init__(self, lib, dev: str, text: str):
        import ctypes
        self.lib, self.ct = lib, ctypes
        h = lib.CXNNetCreate(dev.encode(), text.encode())
        if not h:
            raise RuntimeError("CXNNetCreate: %s"
                               % lib.CXNGetLastError().decode())
        self.h = ctypes.c_void_p(h)

    def _shape(self, dims):
        a = (self.ct.c_uint * 4)()
        for i, d in enumerate(dims):
            a[i] = d
        return a

    def _ptr(self, a):
        return a.ctypes.data_as(self.ct.POINTER(self.ct.c_float))

    def _out(self, p, shape):
        n = int(np.prod(shape))
        return np.ctypeslib.as_array(p, (n,)).reshape(shape).copy()

    def call(self, name, *args):
        getattr(self.lib, name)(self.h, *args)

    def update(self, x, y):
        self.lib.CXNNetUpdateBatch(self.h, self._ptr(x), self._shape(x.shape),
                                   self._ptr(y),
                                   (self.ct.c_uint * 2)(*y.shape))

    def predict(self, x):
        n = self.ct.c_uint()
        p = self.lib.CXNNetPredictBatch(self.h, self._ptr(x),
                                        self._shape(x.shape),
                                        self.ct.byref(n))
        if not p:
            raise RuntimeError(self.lib.CXNGetLastError().decode())
        return self._out(p, (n.value,))

    def extract(self, x, node: str):
        shape = self._shape(())
        p = self.lib.CXNNetExtractBatch(self.h, self._ptr(x),
                                        self._shape(x.shape),
                                        node.encode(), shape)
        if not p:
            raise RuntimeError(self.lib.CXNGetLastError().decode())
        return self._out(p, tuple(shape))

    def weight(self, layer: str, tag: str):
        shape, nd = self._shape(()), self.ct.c_uint()
        p = self.lib.CXNNetGetWeight(self.h, layer.encode(), tag.encode(),
                                     shape, self.ct.byref(nd))
        return None if not p else self._out(p, tuple(shape[:nd.value]))

    def set_weight(self, w, layer: str, tag: str):
        w = np.ascontiguousarray(w, np.float32)
        self.lib.CXNNetSetWeight(self.h, self._ptr(w), w.size,
                                 layer.encode(), tag.encode())


def load_capi():
    """Build (g++, at first use) and bind the port's C ABI library."""
    import ctypes
    from cxxnet_tpu_torch import capi
    t0 = time.perf_counter()
    path = capi.build_library()
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.CXNNetCreate.restype = ctypes.c_void_p
    lib.CXNNetCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for f in ("CXNNetPredictBatch", "CXNNetExtractBatch", "CXNNetGetWeight"):
        getattr(lib, f).restype = fp
    lib.CXNGetLastError.restype = ctypes.c_char_p
    for f in (lib.CXNNetFree, lib.CXNNetInitModel):
        f.argtypes = [ctypes.c_void_p]
    return lib, path, build_s


def phase_capi(workdir: str):
    """The port's C ABI (``cxxnet_tpu_torch/capi``), built here with
    ``g++`` and loaded with ctypes, with ``device = "gpu"`` over
    Inception-BN.conf's net text (``bn_pallas`` and the eval fold through
    ``CXNNetSetParam``) from the wrapper phase's snapshot: ``CAPI_UPDATES``
    ``CXNNetUpdateBatch`` calls on seeded NCHW batches of 128 (each 69 +
    69 bf16 bn_apply and 1 bias_grad_bf16 launches), ``CXNNetPredictBatch``
    and ``CXNNetExtractBatch`` of ``CAPI_ROWS`` rows (69 bf16
    conv_epilogue launches a forward), all the bits of
    ``cxxnet_tpu_torch.wrapper.Net(dev="gpu")`` fed the same calls (cuDNN
    deterministic, both); a ``CXNNetGetWeight`` / ``CXNNetSetWeight``
    round trip; save / load the same bits; and a compiled standalone C
    program (the library owns its interpreter) that creates a net on
    ``"gpu"`` from the fleet phase's calibrated snapshot, predicts and
    writes the ``"top"`` node's rows: ``Net.predict`` / ``Net.extract``
    of the same rows, bit for bit, and the rows distinct."""
    import torch
    from cxxnet_tpu_torch import capi
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.wrapper import Net
    snap = os.path.join(workdir, "wrapper.model.npz")
    calib = os.path.join(workdir, "fleet_models", "0001.model.npz")
    for path, phase in ((snap, "wrapper"), (calib, "fleet")):
        if not os.path.exists(path):
            raise RuntimeError("capi: the %s phase's snapshot is missing"
                               % phase)
    lib, so_path, build_s = load_capi()
    text = wrapper_cfg_text(workdir)
    dev = "gpu" if DEVICE == "cuda" else DEVICE
    rng = np.random.RandomState(SEED + 15)
    batches = []
    for _ in range(CAPI_UPDATES):
        x = images(rng, TRAIN_BATCH)
        if x.shape[1] != CKPT_CROP:
            x = np.ascontiguousarray(x[:, :CKPT_CROP, :CKPT_CROP])
        batches.append((np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
                        rng.randint(0, NCLASS, (TRAIN_BATCH, 1))
                        .astype(np.float32)))
    rows = np.ascontiguousarray(batches[0][0][:CAPI_ROWS])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # the main path, its launch counts from 0
        kernels.reset_launch_counts()
        t_all = time.perf_counter()
        net = CNet(lib, dev, text)
        for k, v in WRAP_KNOBS:
            lib.CXNNetSetParam(net.h, k.encode(), v.encode())
        lib.CXNNetLoadModel(net.h, snap.encode())
        updates = []
        for i, (x, y) in enumerate(batches):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            lib.CXNNetStartRound(net.h, i)
            net.update(x, y)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            updates.append({"ms": (time.perf_counter() - t0) * 1e3,
                            "launches": {k: after[k] - before[k]
                                         for k in after}})
        before = kernels.launch_counts()
        pred = net.predict(rows)
        mid = kernels.launch_counts()
        top = net.extract(rows, "top")
        flat = net.extract(rows, "flat")
        launches = kernels.launch_counts()
        wall_s = time.perf_counter() - t_all
        last_error = lib.CXNGetLastError().decode()
        # the same calls through the Python API (not the main path)
        py = Net(dev=dev, cfg=text)
        for k, v in WRAP_KNOBS:
            py.set_param(k, v)
        py.load_model(snap)
        for i, (x, y) in enumerate(batches):
            py.start_round(i)
            py.update(x, y[:, 0])
        py_pred = py.predict(rows)
        py_top = py.extract(rows, "top")
        py_flat = py.extract(rows, "flat")
        weights = [(lk, tag) for lk, tags in py._trainer.params.items()
                   for tag in tags if tag in ("wmat", "bias")]
        same_weights = all(same_bits(net.weight(lk, tag),
                                     py.get_weight(lk, tag))
                           for lk, tag in weights)
        # GetWeight / SetWeight round trip (flat in, reference layout out)
        w = net.weight("fc1", "wmat")
        net.set_weight(w.ravel() * 0.5, "fc1", "wmat")
        halved = net.weight("fc1", "wmat")
        net.set_weight(w, "fc1", "wmat")
        round_trip = bool(w is not None and same_bits(halved, w * 0.5)
                          and same_bits(net.weight("fc1", "wmat"), w))
        # save / load the same bits
        saved = os.path.join(workdir, "capi.model.npz")
        lib.CXNNetSaveModel(net.h, saved.encode())
        net2 = CNet(lib, dev, text)
        for k, v in WRAP_KNOBS:
            lib.CXNNetSetParam(net2.h, k.encode(), v.encode())
        lib.CXNNetLoadModel(net2.h, saved.encode())
        save_load = all(same_bits(net.weight(lk, tag),
                                  net2.weight(lk, tag))
                        for lk, tag in weights) \
            and same_bits(net2.predict(rows), pred)
        lib.CXNNetFree(net.h)
        lib.CXNNetFree(net2.h)
        del py
    finally:
        torch.backends.cudnn.deterministic = det
    # the standalone C program: the library owns the interpreter; its
    # process runs cuDNN at the defaults, as this one does from here. It
    # predicts from the fleet phase's calibrated snapshot, whose softmax
    # rows are not saturated, and writes the "top" node's bits
    host_src = os.path.join(workdir, "capi_host.c")
    with open(host_src, "w") as f:
        f.write(C_HOST)
    exe = os.path.join(workdir, "capi_host")
    cc = subprocess.run(["gcc", host_src, "-I", capi.CAPI_DIR,
                         "-L", capi.BUILD_DIR,
                         "-Wl,-rpath," + capi.BUILD_DIR,
                         "-lcxxnet_wrapper", "-o", exe],
                        capture_output=True, text=True)
    host = {"compile_rc": cc.returncode, "compile_log": cc.stderr[-800:],
            "model": os.path.relpath(calib, workdir)}
    if cc.returncode == 0:
        cfg_file = os.path.join(workdir, "capi_net.conf")
        with open(cfg_file, "w") as f:
            f.write(text)
        rows_file = os.path.join(workdir, "capi_rows.f32")
        rows.astype("<f4").tofile(rows_file)
        top_file = os.path.join(workdir, "capi_top.f32")
        t0 = time.perf_counter()
        run = subprocess.run([exe, cfg_file, dev, calib, rows_file]
                             + [str(d) for d in rows.shape] + [top_file],
                             capture_output=True, text=True, timeout=600)
        host.update(rc=run.returncode, s=time.perf_counter() - t0,
                    stdout=run.stdout[-400:], stderr=run.stderr[-800:])
        m = re.search(r"C-ABI-OK preds=([\d,]+) top=([\d,]+)", run.stdout)
        host["preds"] = [int(v) for v in m.group(1).split(",")] \
            if m else None
        c_top = None
        if m and os.path.exists(top_file):
            shape = tuple(int(v) for v in m.group(2).split(","))
            c_top = np.fromfile(top_file, "<f4").reshape(shape)
        loaded = Net(dev=dev, cfg=text)
        for k, v in WRAP_KNOBS:
            loaded.set_param(k, v)
        loaded.load_model(calib)
        host["python_preds"] = [int(v) for v in loaded.predict(rows)]
        ref_top = loaded.extract(rows, "top")
        del loaded
        host["top_same_bits"] = c_top is not None and same_bits(c_top,
                                                                ref_top)
        # rows that differ from one another: a net that answers every
        # row alike would not pass
        host["top_rows_distinct"] = None if c_top is None else len(
            {c_top[i].tobytes() for i in range(len(c_top))})
        host["top_row_max"] = None if c_top is None else \
            c_top.reshape(len(c_top), -1).max(axis=1).tolist()
    kernels.restore_launch_counts(launches)
    res = {
        "phase": "capi", "model": "Inception-BN.conf",
        "config": "the port's C ABI (%s, built by g++ in %.2f s) with "
                  "device %r over Inception-BN.conf's netconfig and "
                  "globals (batch %d, 3x%dx%d, %d classes, dtype = "
                  "bfloat16), %s through CXNNetSetParam, from the wrapper "
                  "phase's snapshot; seeded NCHW float32 inputs; cuDNN "
                  "deterministic but in the C program and its "
                  "comparison" % (os.path.relpath(so_path), build_s, dev,
                                     TRAIN_BATCH, CKPT_CROP, CKPT_CROP,
                                     NCLASS, ", ".join("%s = %s" % kv
                                                       for kv in WRAP_KNOBS)),
        "build_s": build_s, "wall_s": wall_s,
        "update_ms": [u["ms"] for u in updates],
        "update_launches": [u["launches"] for u in updates],
        "expected_per_update": CLI_TRAIN_LAUNCHES,
        "predict_launches": {k: mid[k] - before[k] for k in mid},
        "expected_per_forward": CLI_PRED_LAUNCHES,
        "launches": launches, "last_error": last_error,
        "predict": pred.tolist(),
        "predict_same_bits_as_net": same_bits(pred, py_pred),
        "extract_same_bits_as_net": bool(same_bits(top, py_top)
                                         and same_bits(flat, py_flat)),
        "weights_compared": len(weights),
        "weights_same_bits_as_net": bool(same_weights and weights),
        "weight_round_trip": round_trip,
        "save_load_same_bits": bool(save_load),
        "standalone": host}
    res["counted"] = bool(
        all(u["launches"] == CLI_TRAIN_LAUNCHES for u in updates)
        and res["predict_launches"] == CLI_PRED_LAUNCHES)
    res["ok"] = bool(
        res["counted"] and not last_error
        and res["predict_same_bits_as_net"]
        and res["extract_same_bits_as_net"]
        and res["weights_same_bits_as_net"] and round_trip and save_load
        and host.get("rc") == 0 and host.get("preds") is not None
        and host["preds"] == host.get("python_preds")
        and host.get("top_same_bits")
        and host.get("top_rows_distinct") == CAPI_ROWS)
    torch.cuda.empty_cache()
    emit(res)
    if not res["ok"]:
        raise RuntimeError("capi phase failed")
    return res


# ------------------------------------------------------------ phase 15

# the kernel libraries one served forward of Inception-BN.conf's net (the
# eval fold, conv_pallas_epilogue) loads: what an export seals
BUNDLE_PROGRAMS = ["conv_epilogue"]
# a tampered copy's verdict, as the reference's ckpt_verify tests read
# them (tests/test_artifact.py): what is tampered -> a piece of the error
BUNDLE_TAMPER = {"member_byte": "fails its sha256",
                 "marker": "not a JSON object",
                 "manifest_byte": "file_sha256",
                 "uncommitted": "uncommitted"}
COLD_TAG = "cold_child "


def library_of(counter: str) -> str:
    """The ``csrc/`` library whose launch a counter counts."""
    if counter.startswith("conv_epilogue_bwd"):
        return "bn_apply"             # cxn_conv_epilogue_bwd
    for lib in ("conv_epilogue", "bn_apply", "matmul", "relu_max_pool",
                "pool_concat", "bias_grad_bf16"):
        if counter.startswith(lib):
            return lib
    raise KeyError(counter)


def write_conf(path: str, pairs) -> str:
    """Config pairs as a config file the CLI reads back in order."""
    with open(path, "w") as f:
        for k, v in pairs:
            f.write('%s = "%s"\n' % (k, v) if any(c.isspace() for c in v)
                    else "%s = %s\n" % (k, v))
    return path


def run_cli_proc(argv, cwd: str, tag: str):
    """``python -m cxxnet_tpu_torch.main argv`` in a process of its own:
    (rc, stdout lines, seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    with open(os.path.join(cwd, tag + ".stderr.txt"), "w") as err:
        p = subprocess.run([sys.executable, "-m", "cxxnet_tpu_torch.main"]
                           + list(argv) + cli_dev_args(), cwd=cwd, env=env,
                           stdout=subprocess.PIPE, stderr=err, text=True,
                           timeout=600)
    return p.returncode, p.stdout.splitlines(), time.perf_counter() - t0


def tamper_verdicts(bundle: str, workdir: str):
    """A copy of ``bundle`` per ``BUNDLE_TAMPER`` case, tampered, and
    the port's ``verify_bundle`` report of each."""
    from cxxnet_tpu_torch.artifact import bundle as pb
    out = {}
    for case, want in BUNDLE_TAMPER.items():
        b = os.path.join(workdir, "tamper_%s.model.bundle" % case)
        shutil.copytree(bundle, b)
        ok = os.path.join(b, pb.MANIFEST_NAME + pb.OK_SUFFIX)
        if case in ("member_byte", "manifest_byte"):
            name = pb.MANIFEST_NAME if case == "manifest_byte" \
                else "prog-0000.pkl" if os.path.exists(os.path.join(
                    b, "prog-0000.pkl")) else pb.SNAPSHOT_MEMBER
            path = os.path.join(b, name)
            data = bytearray(open(path, "rb").read())
            data[len(data) // 2] ^= 0x01        # same size, one bit
            with open(path, "wb") as f:
                f.write(bytes(data))
        elif case == "marker":
            with open(ok, "w") as f:
                f.write("[]")
        else:
            os.remove(ok)
        rep = pb.verify_bundle(b)
        out[case] = {"ok": rep["ok"], "error": rep["error"][-160:],
                     "as_reference": (not rep["ok"]) and want in rep["error"]}
        shutil.rmtree(b)
    return out


def cold_child(argv) -> int:
    """A serve boot in a fresh process from a copy of the tree without
    ``_build/``: ``argv`` is the parent's clock at the spawn and a spec
    (config pairs, the model, the pool, the output). Writes the seconds
    from the spawn to the first reply, the nvcc builds, the
    ``artifact_load`` record, one reply's launches and row."""
    t_spawn = float(argv[0])
    with open(argv[1]) as f:
        spec = json.load(f)
    import torch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.serve import ServeSession
    t_import = time.time()
    rec = recorder()
    pool = np.load(spec["pool"])
    sess = ServeSession([tuple(p) for p in spec["cfg"]],
                        model_path=spec["model"], monitor=rec,
                        device=spec["device"])
    try:
        t_boot = time.time()
        kernels.reset_launch_counts()
        row = np.asarray(sess.predict(pool[:1]))
        if spec["device"] == "cuda":
            torch.cuda.synchronize()
        t_first = time.time()
        launches = kernels.launch_counts()
    finally:
        sess.close()
    np.save(spec["out"] + ".npy", row)
    art = [r for r in rec.sink.records if r["event"] == "artifact_load"]
    with open(spec["out"], "w") as f:
        json.dump({"import_s": t_import - t_spawn,
                   "boot_s": t_boot - t_spawn,
                   "first_reply_s": t_first - t_spawn,
                   "nvcc_runs": kernels.nvcc_runs,
                   "nvcc_s": sum(float(v["seconds"])
                                 for v in kernels.build_info.values()),
                   "builds": {k: {"seconds": v["seconds"],
                                  "log": str(v["log"])[:24]}
                              for k, v in kernels.build_info.items()},
                   "artifact_load": art[0] if art else None,
                   "launches": launches}, f)
    return 0


def cold_start(workdir: str, cfg, model: str, pool_path: str, tag: str):
    """:func:`cold_child` from a fresh copy of ``cxxnet_tpu_torch/``
    (no ``_build/``) and this script."""
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.join(workdir, tag)
    shutil.copytree(os.path.join(here, "cxxnet_tpu_torch"),
                    os.path.join(tree, "cxxnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.abspath(__file__), tree)
    out = os.path.join(workdir, tag + ".json")
    spec = os.path.join(workdir, tag + ".spec.json")
    with open(spec, "w") as f:
        json.dump({"cfg": [list(p) for p in cfg], "model": model,
                   "pool": pool_path, "out": out, "device": DEVICE}, f)
    env = dict(os.environ, PYTHONPATH=tree)
    t_spawn = time.time()
    with open(os.path.join(workdir, tag + ".stderr.txt"), "w") as err:
        p = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.cold_child(sys.argv[1:]))", repr(t_spawn), spec],
            cwd=tree, env=env, stdout=err, stderr=err, timeout=600)
    if p.returncode != 0:
        with open(os.path.join(workdir, tag + ".stderr.txt")) as f:
            raise RuntimeError("cold start %s exited with %s: %s"
                               % (tag, p.returncode, f.read()[-2000:]))
    with open(out) as f:
        res = json.load(f)
    res["row"] = np.load(out + ".npy")
    build = os.path.join(tree, "cxxnet_tpu_torch", "_build")
    res["built_here"] = sorted(os.listdir(build)) \
        if os.path.isdir(build) else []
    shutil.rmtree(tree)
    return res


@contextlib.contextmanager
def count_forwards():
    """Count every ``NetTrainer.pred`` call, from any thread, while the
    block runs: the served forwards (warmups included) of the trainers
    it builds."""
    import threading
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    orig = NetTrainer.pred
    box, lock = {"n": 0}, threading.Lock()

    def pred(self, *a, **k):
        with lock:
            box["n"] += 1
        return orig(self, *a, **k)

    NetTrainer.pred = pred
    try:
        yield box
    finally:
        NetTrainer.pred = orig


def hot_swap_drive(fcfg, rec, d: str, conf: str, hdir: str, staged: str,
                   pool_path: str):
    """A ``FleetServer`` over the watched ``hdir`` (``0001.model.npz``)
    under binary clients of their own process; meanwhile a thread runs
    two exports through the CLI, each a process of its own: the served
    snapshot into ``0001.model.bundle``, then ``staged`` into
    ``0002.model.bundle``, each waiting for its flip (its commit is the
    marker's mtime, its flip the ``hot_swap`` record's time)."""
    import threading
    import torch
    from cxxnet_tpu_torch.artifact import bundle as pb
    from cxxnet_tpu_torch.serve import FleetServer
    until = os.path.join(d, "hot_swap.done")
    steps = []

    def exports():
        try:
            for i, (model, out) in enumerate((
                    (os.path.join(hdir, "0001.model.npz"),
                     os.path.join(hdir, "0001.model.bundle")),
                    (staged, os.path.join(hdir, "0002.model.bundle")))):
                time.sleep(2.0)
                rc, _, secs = run_cli_proc(
                    [conf, "task=export", "model_in=" + model,
                     "export_out=" + out], d, "hot_export%d" % i)
                step = {"rc": rc, "export_s": secs}
                ok = os.path.join(out, pb.MANIFEST_NAME + pb.OK_SUFFIX)
                steps.append(step)
                if rc != 0 or not os.path.exists(ok):
                    break
                step["t_commit"] = os.stat(ok).st_mtime
                deadline = time.monotonic() + 300
                while time.monotonic() < deadline:
                    sw = [r for r in rec.sink.records
                          if r["event"] == "hot_swap"]
                    if len(sw) > i:
                        step["t_flip"] = sw[i]["t"]
                        break
                    time.sleep(0.02)
                if "t_flip" not in step:
                    break
            time.sleep(2.0)
        finally:
            with open(until, "w") as f:
                f.write("done")

    fleet = FleetServer(fcfg, monitor=rec, device=DEVICE)
    try:
        fleet.start()
        ladder = tuple(fleet.router.resolve("main").session.engine.buckets)
        th = threading.Thread(target=exports)
        cl = start_clients(d, "hot_swap_drive", {
            "http_port": fleet.http_port, "binary_port": fleet.binary_port,
            "pool": pool_path, "swap": None, "http": False,
            "seconds": FLEET_TIMEOUT_S - 60, "until": until})
        th.start()
        drive = finish_clients(cl)
        th.join(timeout=600)
        torch.cuda.synchronize()
        entry = fleet.router.resolve("main")
        summary = fleet.close()
    finally:
        fleet.close(drain=False)
    return {"drive": drive, "steps": steps, "ladder": ladder,
            "swaps": [r for r in rec.sink.records
                      if r["event"] == "hot_swap"],
            "final": (entry.counter, entry.path),
            "summary_errors": summary["requests"]["error"]
            + summary["requests"]["closed"]}


def phase_bundle(workdir: str):
    """Sealed bundles of Inception-BN.conf's net as the fleet phase
    serves it (bf16, the eval fold, the conf's ladder up to 128 rows),
    from the fleet phase's calibrated snapshot: ``task = export`` through
    the CLI (the bundle verifies, its programs are the libraries one
    served forward loads, tampered copies get the reference's verdicts);
    ``task = pred`` / ``pred_raw`` / ``serve`` from the bundle (69 bf16
    conv_epilogue a forward, ``artifact_load`` every program a hit, the
    same bits as from the inner snapshot); a cold start from the bundle
    and from the snapshot, each in a fresh process on a copy of the tree
    without ``_build/`` (the bundle's runs no nvcc); and a watched
    model_dir under binary traffic flipping snapshot -> bundle (the same
    counter) -> a perturbed next bundle, each exported by the CLI in a
    process of its own, with no failed request and every reply the bits
    of a session on the model that served it."""
    import torch
    from cxxnet_tpu_torch.artifact import bundle as pb
    from cxxnet_tpu_torch.artifact.registry import parse_key
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
    from cxxnet_tpu_torch.serve import ServeSession
    src = os.path.join(workdir, "fleet_models", "0001.model.npz")
    pool_path = os.path.join(workdir, "fleet_pool.npy")
    if not (os.path.exists(src) and os.path.exists(pool_path)):
        raise RuntimeError("bundle: the fleet phase's snapshot is missing")
    pool = np.load(pool_path)
    d = os.path.join(workdir, "bundle")
    mdir = os.path.join(d, "models")
    os.makedirs(mdir)
    snap = os.path.join(mdir, "0001.model.npz")
    shutil.copy(src, snap)
    cfg = fleet_cfg(workdir)
    conf = write_conf(os.path.join(d, "serve.conf"), cfg)
    launches = dict(NO_LAUNCHES)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 1. export through the CLI (in process: its launches count)
    exp_stream = os.path.join(d, "export.jsonl")
    er = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with tap_trainer(er):
        rc, lines = run_cli([conf, "task=export", "model_in=" + snap,
                             "monitor=jsonl", "monitor_path=" + exp_stream])
    export_s = time.perf_counter() - t0
    add(kernels.launch_counts())
    bundle = os.path.join(mdir, "0001.model.bundle")
    rep = pb.verify_bundle(bundle)
    man = pb.bundle_manifest(bundle) if rep["ok"] else {"programs": []}
    sealed = sorted(parse_key(p["key"])[1] for p in man["programs"])
    erecs = read_jsonl(exp_stream) if os.path.exists(exp_stream) else []
    exp_rec = [r for r in erecs if r["event"] == "export"]
    # one served forward from the snapshot: the libraries it loads
    ref1 = ServeSession(cfg, model_path=snap, device=DEVICE)
    kernels.reset_launch_counts()
    ref1.predict(pool[:4])
    torch.cuda.synchronize()
    moved = sorted({library_of(k) for k, v in kernels.launch_counts().items()
                    if v})
    export = {
        "rc": rc, "s": export_s, "line": next(
            (ln for ln in lines if ln.startswith("export:")), ""),
        "verify": {k: rep[k] for k in ("ok", "error", "members",
                                       "programs", "committed")},
        "programs": sealed, "moved_in_one_forward": moved,
        "bytes": exp_rec[0]["bytes"] if exp_rec else None,
        "members": [(m["name"], m["bytes"]) for m in man.get("members", [])],
        "fingerprint": man.get("fingerprint"),
        "warmup_forwards": len(er["forwards"]),
        "warmup_counted": bool(er["forwards"] and all(
            f == BF16_LAUNCHES for f in er["forwards"])),
        "tamper": tamper_verdicts(bundle, d),
        "schema_errors": validate_records(erecs, strict=False)[:5]}
    export["ok"] = bool(
        rc == 0 and rep["ok"] and sealed == moved == BUNDLE_PROGRAMS
        and export["warmup_counted"] and exp_rec
        and all(t["as_reference"] for t in export["tamper"].values())
        and not export["schema_errors"])
    # 2. pred / pred_raw / serve from the bundle, pred_raw from the
    # snapshot (raw float32 rows: output_format = bin)
    train_rec = os.path.join(workdir, "train.rec")
    val_rec = os.path.join(workdir, "val.rec")
    iconf = shipped_conf(workdir, "Inception-BN.conf", train_rec, val_rec)
    knobs = ["%s=%s" % kv for kv in KNOBS]
    block = ["iter=imgrec", "path_imgrec=" + val_rec,
             "input_shape=3,%d,%d" % (CKPT_CROP, CKPT_CROP),
             "mean_value=123,117,104", "iter=end"]
    runs = {}
    for name, model, extra in (
            ("pred", bundle, []),
            ("pred_raw", bundle, ["output_format=bin"]),
            ("pred_raw_snapshot", snap, ["output_format=bin"]),
            ("serve", bundle, CLI_SOAK + ["serve_buckets=" + BUCKETS])):
        rec = {}
        task = name.split("_snapshot")[0]
        stream = os.path.join(d, name + ".jsonl")
        outp = os.path.join(d, name + ".out")
        kernels.reset_launch_counts()
        with tap_trainer(rec):
            rc, lines = run_cli([iconf, "task=" + task, "model_in=" + model]
                                + knobs + extra
                                + ["monitor=jsonl", "monitor_path=" + stream,
                                   "pred=" + outp] + block)
        counts = kernels.launch_counts()
        if model == bundle:
            add(counts)
        recs = read_jsonl(stream) if os.path.exists(stream) else []
        art = [r for r in recs if r["event"] == "artifact_load"]
        runs[name] = {
            "rc": rc, "forwards": len(rec["forwards"]),
            "counted": bool(rec["forwards"] and all(
                f == BF16_LAUNCHES for f in rec["forwards"])
                and counts == {k: v * len(rec["forwards"])
                               for k, v in BF16_LAUNCHES.items()}),
            "artifact_load": {k: art[0][k] for k in (
                "fingerprint_match", "hits", "rebuilds")} if art else None,
            "schema_errors": validate_records(recs, strict=False)[:3]}
        if task == "serve":
            runs[name]["soak"] = serve_line(lines)
    with open(os.path.join(d, "pred_raw.out"), "rb") as f:
        raw_bundle = f.read()
    with open(os.path.join(d, "pred_raw_snapshot.out"), "rb") as f:
        raw_snap = f.read()
    nprog = len(sealed)
    boot = {"runs": runs, "raw_bytes": len(raw_bundle),
            "same_bits_as_snapshot": raw_bundle == raw_snap
            and len(raw_bundle) == 4 * CLI_VAL_RECORDS * NCLASS}
    boot["ok"] = bool(
        boot["same_bits_as_snapshot"]
        and all(r["rc"] == 0 and r["counted"] and not r["schema_errors"]
                for r in runs.values())
        and all(runs[n]["artifact_load"] == {
            "fingerprint_match": True, "hits": nprog, "rebuilds": 0}
            for n in ("pred", "pred_raw", "serve"))
        and runs["pred_raw_snapshot"]["artifact_load"] is None
        and (runs["serve"]["soak"] or {}).get("failed") == 0
        and (runs["serve"]["soak"] or {}).get("ok") == 64)
    # 3. cold start: a fresh process on a fresh tree, from the bundle and
    # from the snapshot
    cold = {}
    for tag, model in (("cold_bundle", bundle), ("cold_snapshot", snap)):
        cold[tag] = cold_start(d, cfg, model, pool_path, tag)
        add(cold[tag]["launches"])
    cb, cs = cold["cold_bundle"], cold["cold_snapshot"]
    cold_res = {
        tag: {k: c[k] for k in ("import_s", "boot_s", "first_reply_s",
                                "nvcc_runs", "nvcc_s", "builds",
                                "artifact_load", "built_here")}
        for tag, c in cold.items()}
    cold_res.update(
        nvcc_s_saved=cs["nvcc_s"] - cb["nvcc_s"],
        first_reply_s_saved=cs["first_reply_s"] - cb["first_reply_s"],
        same_bits=same_bits(cb["row"], cs["row"]))
    cold_res["ok"] = bool(
        cb["nvcc_runs"] == 0 and cs["nvcc_runs"] == len(BUNDLE_PROGRAMS)
        and cb["artifact_load"] and cb["artifact_load"]["hits"] == nprog
        and cb["artifact_load"]["fingerprint_match"]
        and cb["built_here"] == cs["built_here"]
        and all(c["launches"] == BF16_LAUNCHES for c in cold.values())
        and cold_res["same_bits"])
    # 4. hot-swap: snapshot -> its bundle -> a perturbed next bundle,
    # each export a CLI process of its own, under binary traffic
    hdir = os.path.join(d, "watched")
    os.makedirs(hdir)
    shutil.copy(snap, os.path.join(hdir, "0001.model.npz"))
    staged = os.path.join(d, "staged", "0002.model.npz")
    os.makedirs(os.path.dirname(staged))
    perturbed_snapshot(snap, staged)
    ref2 = ServeSession(cfg, model_path=staged, device=DEVICE)
    rec = recorder()
    fcfg = cfg + [("serve_models", "main=%s" % hdir),
                  ("serve_http_port", "-1"), ("serve_binary_port", "0"),
                  ("serve_swap_poll_s", "0.2")]
    kernels.reset_launch_counts()
    with count_forwards() as fwd:
        hs = hot_swap_drive(fcfg, rec, d, conf, hdir, staged, pool_path)
    forwards = fwd["n"]
    counts = kernels.launch_counts()
    add(counts)
    drive, steps, swaps, final, ladder = (hs["drive"], hs["steps"],
                                          hs["swaps"], hs["final"],
                                          hs["ladder"])
    refs = {1: bucket_refs(ref1, pool, ladder),
            2: bucket_refs(ref2, pool, ladder)}
    for s in (ref1, ref2):
        s.close()
    served = {"old": 0, "new": 0, "neither": 0, "late_old": 0}
    t_last = steps[-1].get("t_flip") if steps else None
    for r in drive["log"]:
        if r["status"] != "ok":
            continue
        n, st = r["n"], r["start"]
        got = np.asarray(r["result"]).reshape(n, -1)
        hit = next((snap_i for snap_i in (1, 2) for bk in ladder
                    if bk >= n and same_bits(
                        got, refs[snap_i][bk][st:st + n])), None)
        if hit is None:
            served["neither"] += 1
            continue
        served["old" if hit == 1 else "new"] += 1
        if hit == 1 and t_last is not None and r["t_send"] >= t_last:
            served["late_old"] += 1
    failed = [(r["proto"], r["status"], str(r["result"])[:160])
              for r in drive["log"] if r["status"] != "ok"]
    hot = {
        "exports": steps,
        "commit_to_flip_s": [s["t_flip"] - s["t_commit"] for s in steps
                             if "t_flip" in s],
        "flips": [(r["old_counter"], r["new_counter"],
                   os.path.basename(r["path"]), r["wall_ms"])
                  for r in swaps],
        "final": [final[0], os.path.basename(final[1])],
        "requests": len(drive["log"]), "n_failed": len(failed),
        "failed": failed[:5], "client_errors": drive["errors"][:5],
        "served_by": served,
        "by_protocol": proto_stats(drive["log"],
                                   drive["t_end"] - drive["t0"],
                                   ("cxn1", "cxn2")),
        "summary_errors": hs["summary_errors"],
        "forwards": forwards, "launches": counts,
        "schema_errors": validate_records(rec.sink.records,
                                          strict=False)[:5]}
    hot["ok"] = bool(
        len(steps) == 2 and all(s["rc"] == 0 and "t_flip" in s
                                for s in steps)
        and [(f[0], f[1], f[2]) for f in hot["flips"]]
        == [(1, 1, "0001.model.bundle"), (1, 2, "0002.model.bundle")]
        and final[0] == 2 and not failed and not drive["errors"]
        and not drive["alive"] and served["neither"] == 0
        and served["late_old"] == 0 and served["old"] > 0
        and served["new"] > 0 and hot["summary_errors"] == 0
        and forwards > 0
        and counts == {k: v * forwards for k, v in BF16_LAUNCHES.items()}
        and not hot["schema_errors"])
    torch.cuda.empty_cache()
    res = {"phase": "bundle", "model": "Inception-BN.conf",
           "config": "the fleet phase's net and knobs (dtype = bfloat16, "
                     "%s, buckets auto 1-128) from its calibrated "
                     "snapshot" % ", ".join("%s = %s" % kv for kv in KNOBS),
           "export": export, "boot": boot, "cold_start": cold_res,
           "hot_swap": hot, "launches": launches}
    res["ok"] = bool(export["ok"] and boot["ok"] and cold_res["ok"]
                     and hot["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("bundle phase failed")
    return res


# ------------------------------------------------------------ phase 16

# MNIST_CONTINUAL.conf as shipped, with these overrides (listed in the
# phase's output); the port file and the paths are where the phase
# reads them
CONT_MNIST_OVERRIDES = ["serve_http_port=0", "serve_binary_port=0",
                        "continual_linger_s=0", "continual_generations=3"]
# Inception-BN.conf under task = continual on the cli phase's archives
CONT_INCEPTION_OVERRIDES = ["continual_export_every=6",
                            "continual_generations=2", "continual_gate=off",
                            "serve_http_port=-1", "serve_binary_port=0",
                            "bn_pallas=1", "bn_fuse_relu=1"]
CONT_POOL = 48                 # MNIST test digits the clients draw from
# the continual phase's binary clients: 1-4 rows a request, CXN2 4 in
# flight, so the shipped configs' queue bounds (8x serve_max_batch rows)
# are never what answers
CONT_MAX_ROWS, CONT_V2_DEPTH = 4, 4


@contextlib.contextmanager
def tap_continual(on_generation):
    """Call ``on_generation(loop, record)`` after every generation record
    of each ``ContinualLoop`` the CLI builds (its own hook is kept)."""
    from cxxnet_tpu_torch.continual import loop as cl
    orig = cl.ContinualLoop.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        own = self._on_generation

        def hook(rec, loop=self):
            on_generation(loop, rec)
            if own is not None:
                own(rec)
        self._on_generation = hook

    cl.ContinualLoop.__init__ = init
    try:
        yield
    finally:
        cl.ContinualLoop.__init__ = orig


def continual_run(argv, cwd: str, d: str, tag: str, pool_path: str,
                  model: str = "default"):
    """``task = continual`` through the CLI in process (its updates and
    forwards tapped), with binary clients of a process of their own on
    its fleet from the first boot (they read ``serve_port_file``): at the
    last deployed generation the hook stops the clients and waits for
    them, so the loop's drain meets no request in flight; at the first
    (the fleet's boot) it waits for their first ok reply, so the
    traffic spans every flip."""
    from cxxnet_tpu_torch.layers import kernels
    port_file = os.path.join(d, tag + ".port.json")
    until = os.path.join(d, tag + ".done")
    started = os.path.join(d, tag + ".started")
    gens = []
    cl = start_clients(d, tag + "_clients", {
        "port_file": port_file, "pool": pool_path, "swap": None,
        "http": False, "seconds": FLEET_TIMEOUT_S - 60, "until": until,
        "model": model, "started": started,
        "max_rows": CONT_MAX_ROWS, "v2_depth": CONT_V2_DEPTH})

    def on_generation(loop, rec):
        gens.append(dict(rec, t_hook=time.time()))
        done = sum(g["action"] == "deployed" for g in gens)
        if rec.get("boot"):
            deadline = time.monotonic() + 120
            while not os.path.exists(started) and cl["p"].poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
        if done >= loop.cc.generations:
            with open(until, "w") as f:
                f.write("done")
            cl["p"].wait(timeout=120)

    tap = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with tap_continual(on_generation), tap_trainer(tap), \
                count_forwards() as fwd:
            rc, lines = run_cli(list(argv) + ["serve_port_file=" + port_file],
                                cwd=cwd)
    finally:
        if not os.path.exists(until):
            with open(until, "w") as f:
                f.write("done")
    wall = time.perf_counter() - t0
    drive = finish_clients(cl)
    return {"rc": rc, "lines": lines, "wall_s": wall, "gens": gens,
            "tap": tap, "forwards": fwd["n"],
            "launches": kernels.launch_counts(), "drive": drive}


def _flips(recs):
    """The ``hot_swap`` records of a stream as (new counter, basename):
    a generation's snapshot commits before its bundle, so the watcher
    may flip to the snapshot first and then to the bundle of its
    counter, as the reference's watcher may."""
    return [(r["new_counter"], os.path.basename(r["path"].rstrip("/")))
            for r in recs if r["event"] == "hot_swap"]


def _flipped_in(flips, gens) -> bool:
    """Every deployed generation after the first (the fleet's boot) was
    flipped in, in order, and the last flip serves the last one."""
    want = [g["counter"] for g in gens if g["action"] == "deployed"][1:]
    got = [c for c, _ in flips]
    return bool(want) and got == sorted(got) and set(got) == set(want) \
        and got[-1] == want[-1]


def _client_stats(drive):
    failed = [(r["proto"], r["status"], str(r["result"])[:160])
              for r in drive["log"] if r["status"] != "ok"]
    return {"requests": len(drive["log"]), "n_failed": len(failed),
            "failed": failed[:5], "errors": drive["errors"][:5],
            "alive": drive["alive"],
            "by_protocol": proto_stats(drive["log"],
                                       max(drive["t_end"] - drive["t0"],
                                           1e-9), ("cxn1", "cxn2"))}


def phase_continual(workdir: str):
    """``task = continual`` on the card, through the CLI, with binary
    clients on its fleet throughout: example/MNIST/MNIST_CONTINUAL.conf
    as shipped on the tracked digits (``CONT_MNIST_OVERRIDES``: every
    generation deployed or gate-skipped, its metric printed, no failed
    request), then Inception-BN.conf on the cli phase's archives
    (``CONT_INCEPTION_OVERRIDES`` with the eval fold: exactly 69 + 69
    bf16 bn_apply and 1 bias_grad_bf16 an update, 69 bf16 conv_epilogue
    a forward and no other launch; generation 2's export reloads the
    engine in place and runs no nvcc; its flip fails no request), with
    the update time and the time per generation."""
    import torch
    from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
    here = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(workdir, "continual")
    os.makedirs(d)
    launches = dict(NO_LAUNCHES)
    # A. MNIST_CONTINUAL.conf as shipped
    md = os.path.join(d, "mnist")
    os.makedirs(md)
    os.symlink(os.path.join(here, "example", "MNIST", "data"),
               os.path.join(md, "data"))
    with open(os.path.join(md, "data", "t10k-images-idx3-ubyte"),
              "rb") as f:
        f.read(16)
        digits = np.frombuffer(f.read(CONT_POOL * 784), np.uint8)
    mpool = os.path.join(d, "mnist_pool.npy")
    np.save(mpool, (digits.reshape(CONT_POOL, 1, 784, 1)
                    .astype(np.float32) / 256.0))
    conf = os.path.join(here, "example", "MNIST", "MNIST_CONTINUAL.conf")
    mr = continual_run([conf] + CONT_MNIST_OVERRIDES, md, d, "mnist",
                       mpool)
    for k, v in mr["launches"].items():
        launches[k] += v
    mrecs = read_jsonl(os.path.join(md, "mnist_continual.jsonl"))
    mg = [r for r in mrecs if r["event"] == "generation"]
    mroll = [r for r in mrecs if r["event"] == "continual"]
    mnist = {
        "rc": mr["rc"], "wall_s": mr["wall_s"],
        "overrides": CONT_MNIST_OVERRIDES + ["serve_port_file=<phase>"],
        "generations": [{k: g.get(k) for k in (
            "generation", "action", "metric", "value", "train_updates",
            "wall_ms", "swap_wall_s", "export_ms")} for g in mg],
        "summary": mroll[0] if mroll else None,
        "flips": _flips(mrecs),
        "clients": _client_stats(mr["drive"]),
        "lines": [ln for ln in mr["lines"] if ln.startswith("continual:")
                  or ln.startswith("[gen")],
        "schema_errors": validate_records(mrecs, strict=False)[:5]}
    mnist["ok"] = bool(
        mr["rc"] == 0 and mg
        and all(g["action"] in ("deployed", "gate_skipped") for g in mg)
        and sum(g["action"] == "deployed" for g in mg) == 3
        and _flipped_in(mnist["flips"], mg)
        and mnist["clients"]["requests"] > 0
        and mnist["clients"]["n_failed"] == 0
        and not mnist["clients"]["errors"] and not mnist["clients"]["alive"]
        and not mnist["schema_errors"])
    # B. Inception-BN.conf under task = continual, the eval fold on
    train_rec = os.path.join(workdir, "train.rec")
    val_rec = os.path.join(workdir, "val.rec")
    iconf = shipped_conf(workdir, "Inception-BN.conf", train_rec, val_rec)
    stream = os.path.join(d, "inception.jsonl")
    ir = continual_run(
        [iconf, "task=continual", "model_dir=" + os.path.join(d, "models"),
         "monitor=jsonl", "monitor_path=" + stream]
        + ["%s=%s" % kv for kv in KNOBS] + CONT_INCEPTION_OVERRIDES,
        d, d, "inception", os.path.join(workdir, "fleet_pool.npy"))
    torch.cuda.synchronize()
    for k, v in ir["launches"].items():
        launches[k] += v
    irecs = read_jsonl(stream) if os.path.exists(stream) else []
    ig = [r for r in irecs if r["event"] == "generation"]
    iroll = [r for r in irecs if r["event"] == "continual"]
    ups = ir["tap"]["updates"]
    nup = sum(u["batches"] for u in ups)
    expected = {k: CLI_TRAIN_LAUNCHES[k] * nup
                + BF16_LAUNCHES[k] * ir["forwards"] for k in NO_LAUNCHES}
    t_start = [r["t"] for r in irecs if r["event"] == "run_start"][:1]
    t_gen = t_start + [g["t"] for g in ig]
    inception = {
        "rc": ir["rc"], "wall_s": ir["wall_s"],
        "overrides": CONT_INCEPTION_OVERRIDES
        + ["%s=%s" % kv for kv in KNOBS],
        "updates": nup, "forwards": ir["forwards"],
        "launches": ir["launches"], "expected": expected,
        "counted": ir["launches"] == expected and nup > 0
        and ir["forwards"] > 0,
        "update_ms": [round(u["ms"] / u["batches"], 3) for u in ups],
        "update_ms_median": float(np.median(
            [u["ms"] / u["batches"] for u in ups])) if ups else None,
        "generations": [{k: g.get(k) for k in (
            "generation", "action", "train_updates", "wall_ms",
            "export_ms", "export_engine_built", "export_nvcc_runs",
            "swap_wall_s", "export_programs")} for g in ig],
        # run start to generation 1, generation 1 to 2 (the records'
        # clock): training, the gate's eval, snapshot, export and flip
        "generation_s": [b - a for a, b in zip(t_gen, t_gen[1:])],
        "summary": iroll[0] if iroll else None,
        "flips": _flips(irecs),
        "clients": _client_stats(ir["drive"]),
        "lines": [ln for ln in ir["lines"] if ln.startswith("continual:")],
        "schema_errors": validate_records(irecs, strict=False)[:5]}
    inception["ok"] = bool(
        ir["rc"] == 0 and inception["counted"] and len(ig) == 2
        and all(g["action"] == "deployed" for g in ig)
        and ig[0].get("export_engine_built") is True
        and ig[1].get("export_engine_built") is False
        and ig[1].get("export_nvcc_runs") == 0
        and all(g.get("export_programs") == len(BUNDLE_PROGRAMS)
                for g in ig)
        and iroll and _flipped_in(inception["flips"], ig)
        and inception["clients"]["requests"] > 0
        and inception["clients"]["n_failed"] == 0
        and not inception["clients"]["errors"]
        and not inception["clients"]["alive"]
        and not inception["schema_errors"])
    torch.cuda.empty_cache()
    res = {"phase": "continual", "mnist": mnist, "inception": inception,
           "launches": launches}
    res["ok"] = bool(mnist["ok"] and inception["ok"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("continual phase failed")
    return res


# ------------------------------------------------------------ phase 17

# task = fleet over Inception-BN.conf replicas, booted from the bundle
# phase's bundles: the calibrated snapshot's, and as the canary the
# perturbed next one's
TIER_CANARY_FRACTION = 0.25
TIER_CANARY_WINDOW_S = 25.0    # from the canary's arm: spans the kill and heal
TIER_CANARY_MIN = 40           # canary requests the decision needs
# replicas of both versions share one card, and the baseline's window
# holds the kill's retries: a canary only as slow as they are promotes
TIER_CANARY_P99_RATIO = 4.0
TIER_COALESCE_MS = 2.0
# the over-quota tenant is shed by design, and the queues of six clients
# are the load the replicas are sized for: neither scales the fleet out,
# so the replica after the kill is the controller's heal
TIER_SHED_HI = 1.0
TIER_QUEUE_HI = 4.0
# a merged batch closes once it holds this many rows, so it has at most
# 111 + 16: one micro-batch of the ladder's top bucket (128)
TIER_COALESCE_ROWS = 112
TIER_KILL_AFTER_S = 4.0        # traffic before a replica's or door's SIGKILL
TIER_AFTER_S = 4.0             # traffic after the decision / the door's heal
TIER_WAIT_S = 420.0            # a drive's limit
TIER_MEMBER = "import sys, chip_smoke; sys.exit(chip_smoke.%s(sys.argv[1:]))"


def door_traffic(endpoints, pool, until: str, model: str,
                 started: str = "", clients: int = 4, max_rows: int = 16):
    """Binary clients of a sharded front tier: ``clients``
    ``FailoverBinaryClient`` s over ``endpoints`` (every other one in
    reverse order, so that half start at each door), 1 to ``max_rows``
    rows a request, until the file ``until`` exists (``started`` written
    at the first ok reply). Returns every request's record, as
    :func:`fleet_traffic` does, and each client's failovers. Runs in
    :func:`fleet_clients`' process."""
    import threading
    from cxxnet_tpu_torch.serve.frontend import FailoverBinaryClient
    stop = threading.Event()
    lock = threading.Lock()
    log, errors, failovers = [], [], [0] * clients
    flat = pool.reshape(pool.shape[0], -1)

    def client(ci):
        rng = np.random.RandomState(SEED + 50 + ci)
        fc = FailoverBinaryClient(
            list(reversed(endpoints)) if ci % 2 else list(endpoints),
            timeout=300)
        try:
            while not stop.is_set():
                n = int(rng.randint(1, max_rows + 1))
                s = int(rng.randint(0, len(pool) - n + 1))
                t = time.time()
                st, res = fc.predict(flat[s:s + n], model=model,
                                     tenant="door-%d" % ci)
                with lock:
                    log.append({"proto": "cxn1", "tenant": "door-%d" % ci,
                                "start": s, "n": n, "status": st,
                                "result": res, "t_send": t,
                                "ms": (time.time() - t) * 1e3,
                                "extra": None})
                    if started and st == "ok" \
                            and not os.path.exists(started):
                        with open(started, "w") as f:
                            f.write(repr(t))
        except Exception as e:                  # surfaced by the checks
            with lock:
                errors.append("%s: %s" % (type(e).__name__, e))
        finally:
            failovers[ci] = fc.failovers
            fc.close()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + FLEET_TIMEOUT_S - 60
        while time.monotonic() < deadline and not os.path.exists(until):
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
    return {"log": log, "errors": errors, "t0": t0, "t_end": time.time(),
            "t_commit": None, "t_swap": None, "failovers": failovers,
            "alive": sum(t.is_alive() for t in threads)}


def _port_file_arg(argv) -> str:
    return next(a.split("=", 1)[1] for a in argv
                if a.startswith(("serve_port_file=", "fleet_port_file=")))


def fleet_member(argv) -> int:
    """One process of the tier (a replica or a door): ``argv[0]`` is the
    spawner's clock at the spawn, the rest the arguments of
    ``python -m cxxnet_tpu_torch.main``. Runs that entry point with every
    launch count from 0 and every served forward counted
    (:func:`count_forwards`), and after it returns (SIGTERM drains it)
    writes beside its port file (``<id>.counts.json``) its pid, exit
    code, forwards, launches, nvcc runs, kernel build logs and whether it
    initialized CUDA. A SIGKILLed member writes nothing."""
    args = argv[1:]
    import torch
    from cxxnet_tpu_torch import main as pmain
    from cxxnet_tpu_torch.layers import kernels
    out = _port_file_arg(args)[:-len(".ports.json")] + ".counts.json"
    kernels.reset_launch_counts()
    with count_forwards() as fwd:
        rc = pmain.main(args)
    res = {"pid": os.getpid(), "rc": rc, "t_spawn": float(argv[0]),
           "forwards": fwd["n"], "launches": kernels.launch_counts(),
           "nvcc_runs": kernels.nvcc_runs,
           "builds": {k: str(v["log"])[:24]
                      for k, v in kernels.build_info.items()},
           "cuda_initialized": torch.cuda.is_initialized()}
    with open(out + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(out + ".tmp", out)
    return rc


def tier_child(argv) -> int:
    """``python -m cxxnet_tpu_torch.main argv[1:]`` (``task = fleet``)
    in this process, with the ``Launcher`` seam
    (``fleet.placement.LocalLauncher.launch``) swapped so that every
    replica and door it spawns runs the same entry point through
    :func:`fleet_member`. Writes to ``argv[0]`` its pid, exit code,
    whether it initialized CUDA and each member id's spawn clocks."""
    import torch
    from cxxnet_tpu_torch import main as pmain
    from cxxnet_tpu_torch.fleet import placement
    orig = placement.LocalLauncher.launch
    spawns = {}

    def launch(self, cmd, log_path):
        if list(cmd[1:3]) != ["-m", "cxxnet_tpu_torch.main"]:
            raise RuntimeError("unexpected spawn command %r" % (cmd,))
        t = time.time()
        mid = os.path.basename(_port_file_arg(cmd))[:-len(".ports.json")]
        spawns.setdefault(mid, []).append(t)
        return orig(self, [cmd[0], "-c", TIER_MEMBER % "fleet_member",
                           repr(t)] + list(cmd[3:]), log_path)

    placement.LocalLauncher.launch = launch
    rc = pmain.main(argv[1:])
    with open(argv[0], "w") as f:
        json.dump({"pid": os.getpid(), "rc": rc, "spawns": spawns,
                   "cuda_initialized": torch.cuda.is_initialized()}, f)
    return rc


def tier_proc(d: str, tag: str, argv):
    """:func:`tier_child` over ``argv`` in a process of its own."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH", "")) if p))
    out = os.path.join(d, tag + ".child.json")
    log = open(os.path.join(d, tag + ".log"), "w")
    p = subprocess.Popen([sys.executable, "-c", TIER_MEMBER % "tier_child",
                          out] + list(argv) + cli_dev_args(), cwd=d,
                         env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"p": p, "out": out, "log": log, "tag": tag}


def tier_wait(cond, procs, what: str, limit: float = TIER_WAIT_S):
    """Poll ``cond()`` every 0.1 s until it returns a true value; raise
    if a process of ``procs`` (:func:`tier_proc` or
    :func:`start_clients` handles) exits first, or past ``limit``."""
    from cxxnet_tpu_torch.fleet.replica import _log_tail
    deadline = time.monotonic() + limit
    while True:
        v = cond()
        if v:
            return v
        for pr in procs:
            if pr["p"].poll() is not None:
                path = pr["log"].name if "log" in pr \
                    else pr["out"] + ".stderr.txt"
                raise RuntimeError("fleet_tier: %s exited with %s before "
                                   "%s: %s" % (pr["tag"], pr["p"].returncode,
                                               what, _log_tail(path)))
        if time.monotonic() > deadline:
            raise RuntimeError("fleet_tier: no %s within %.0f s"
                               % (what, limit))
        time.sleep(0.1)


def stop_tier(proc, registry, limit: float = 180.0):
    """SIGTERM the fleet process (it drains its replicas and doors) and
    wait for it; then SIGKILL whatever member the registry still names.
    Returns the exit code and :func:`tier_child`'s record."""
    import signal
    p = proc["p"]
    if p.poll() is None:
        p.send_signal(signal.SIGTERM)
        try:
            p.wait(timeout=limit)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    proc["log"].close()
    for e in registry.endpoints():
        if e.get("pid"):
            try:
                os.kill(int(e["pid"]), signal.SIGKILL)
            except ProcessLookupError:
                pass                     # drained and gone, as it should
    out = None
    if os.path.exists(proc["out"]):
        with open(proc["out"]) as f:
            out = json.load(f)
    return p.returncode, out


def gpu_pids():
    """``{pid: used_memory}`` of the card's compute processes, as
    ``nvidia-smi --query-compute-apps=pid,used_memory`` lists them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except FileNotFoundError:             # a CPU rehearsal
        return {}
    pids = {}
    for line in out.splitlines():
        parts = [s.strip() for s in line.split(",")]
        if parts[0].isdigit():
            pids[int(parts[0])] = parts[1] if len(parts) > 1 else ""
    return pids


def nvidia_files(pid: int):
    """The ``/dev/nvidia*`` files process ``pid`` holds open (its
    ``/proc/<pid>/fd``; None when it is gone): a CUDA context holds its
    card's (``/dev/nvidia<N>``)."""
    d = "/proc/%d/fd" % pid
    try:
        fds = os.listdir(d)
    except OSError:
        return None
    out = set()
    for fd in fds:
        try:
            target = os.readlink(os.path.join(d, fd))
        except OSError:
            continue                     # closed while we looked
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def on_card(members, fleet_pid):
    """Where the tier's processes live, read while they run: the card's
    compute processes as ``nvidia-smi`` lists them, and the
    ``/dev/nvidia*`` files each process holds. Replicas must hold their
    card's device file (``/dev/nvidia<N>``) and the fleet process and
    doors none; where the
    listing names this machine's pids (a pid namespace can hide them),
    the replicas must be in it and the others not."""
    rpids = [int(e["pid"]) for e in members if e["role"] == "replica"]
    others = [int(e["pid"]) for e in members
              if e["role"] == "balancer" and e.get("pid")] + [fleet_pid]
    smi = gpu_pids()
    files = {p: nvidia_files(p) for p in rpids + others}
    named = any(p in smi for p in rpids + others)
    card = [p for p in rpids + others
            if any(re.match(r"/dev/nvidia\d+$", f) for f in files[p] or ())]
    return {"listed": smi, "listing_names_pids": named,
            "replica_pids": rpids, "other_pids": others,
            "nvidia_files": files,
            "replicas_on_card": bool(rpids) and set(rpids) <= set(card)
            and (not named or all(p in smi for p in rpids)),
            "others_off_card": not set(others) & set(card)
            and not any(p in smi for p in others)}


def member_counts(fdir: str):
    """Every :func:`fleet_member` record under ``fdir``, by member id."""
    out = {}
    for name in sorted(os.listdir(fdir)):
        if name.endswith(".counts.json"):
            with open(os.path.join(fdir, name)) as f:
                out[name[:-len(".counts.json")]] = json.load(f)
    return out


def attribute(log, refs, ladder, t_switch=None):
    """Each ok reply of ``log`` against ``refs`` (``{version: {bucket:
    rows}}``) at every bucket that could hold it: how many matched each
    version, how many neither (and the worst distance then), and how
    many replies sent after ``t_switch`` were not of the last version."""
    versions = list(refs)
    served = dict({v: 0 for v in versions}, neither=0, late_other=0)
    worst = 0.0
    for r in log:
        if r["status"] != "ok":
            continue
        n, st = r["n"], r["start"]
        got = np.asarray(r["result"]).reshape(n, -1)
        cands = [(v, bk) for v in versions for bk in ladder if bk >= n]
        hit = next((v for v, bk in cands
                    if same_bits(got, refs[v][bk][st:st + n])), None)
        if hit is None:
            served["neither"] += 1
            worst = max(worst, min(float(np.abs(
                got - refs[v][bk][st:st + n]).max()) for v, bk in cands))
            continue
        served[hit] += 1
        if t_switch is not None and r["t_send"] >= t_switch \
                and hit != versions[-1]:
            served["late_other"] += 1
    served["worst_mismatch"] = worst
    return served


def phase_fleet_tier(workdir: str, fres):
    """The horizontal tier (``task = fleet``, ``fleet/``) over
    Inception-BN.conf replica processes on the card (bf16, the eval fold,
    the conf's ladder 1-128), each a ``task = serve_fleet`` child booted
    from a sealed bundle of the bundle phase. Drive A: one fleet process
    (2 replicas, at most 3, balancer coalescing, a canary of the
    perturbed bundle at a quarter of the traffic) under HTTP, CXN1 and
    CXN2 clients of a process of their own and the over-quota tenant; a
    baseline replica SIGKILLed mid-traffic and healed from the bundle;
    the canary run to its decision (the whole fleet rolled to it on a
    promote). Drive B: a sharded front tier (``fleet_balancers = 2``)
    under ``FailoverBinaryClient`` s, one door SIGKILLed mid-traffic and
    respawned. No failed request of an in-quota tenant; each ok reply the
    bits of a ``ServeSession`` on one of the two snapshots at a bucket
    that could hold it, and after a promote the canary's; the replicas on
    the card (``nvidia-smi``), the fleet processes and doors not (nor
    CUDA initialized in them); each replica's launches exactly 69 bf16
    conv_epilogue a served forward (the Launcher seam runs each member
    through :func:`fleet_member`); no nvcc in a bundle boot."""
    import signal
    import torch
    from cxxnet_tpu_torch.fleet.placement import EndpointRegistry
    from cxxnet_tpu_torch.monitor.schema import (read_jsonl, validate_record,
                                                 validate_records)
    from cxxnet_tpu_torch.serve import ServeSession
    snap1 = os.path.join(workdir, "fleet_models", "0001.model.npz")
    snap2 = os.path.join(workdir, "bundle", "staged", "0002.model.npz")
    base = os.path.join(workdir, "bundle", "models", "0001.model.bundle")
    cane = os.path.join(workdir, "bundle", "watched", "0002.model.bundle")
    pool_path = os.path.join(workdir, "fleet_pool.npy")
    for path in (snap1, snap2, base, cane, pool_path):
        if not os.path.exists(path):
            raise RuntimeError("fleet_tier: %s of an earlier phase is "
                               "missing" % path)
    pool = np.load(pool_path)
    d = os.path.join(workdir, "fleet_tier")
    os.makedirs(d)
    cfg = fleet_cfg(workdir)
    conf = write_conf(os.path.join(d, "tier.conf"),
                      cfg + [("serve_quota", FLEET_QUOTA)])
    torch.cuda.empty_cache()
    adir, bdir = os.path.join(d, "a"), os.path.join(d, "b")
    areg = EndpointRegistry(os.path.join(adir, "endpoints.json"))
    breg = EndpointRegistry(os.path.join(bdir, "endpoints.json"))
    decision = os.path.join(d, "canary_decision.json")
    astream, bstream = os.path.join(d, "a.jsonl"), os.path.join(d, "b.jsonl")
    common = ["task=fleet", "model_in=" + base, "fleet_duration_s=0",
              "monitor=jsonl", "monitor_flush_period=0.2"]
    a_argv = [conf] + common + [
        "fleet_replicas=2", "fleet_max_replicas=3",
        "fleet_coalesce_ms=%g" % TIER_COALESCE_MS,
        "fleet_coalesce_rows=%d" % TIER_COALESCE_ROWS,
        "fleet_shed_hi=%g" % TIER_SHED_HI,
        "fleet_queue_hi=%g" % TIER_QUEUE_HI, "fleet_dir=" + adir, "fleet_registry=" + areg.path,
        "canary_source=" + cane,
        "canary_fraction=%g" % TIER_CANARY_FRACTION,
        "canary_window_s=%g" % TIER_CANARY_WINDOW_S,
        "canary_min_requests=%d" % TIER_CANARY_MIN,
        "canary_p99_ratio=%g" % TIER_CANARY_P99_RATIO,
        "canary_out=" + decision, "monitor_path=" + astream]
    b_argv = [conf] + common + [
        "fleet_replicas=1", "fleet_balancers=2", "fleet_gossip_s=0.2",
        "fleet_health_poll_s=0.2", "fleet_dir=" + bdir,
        "fleet_registry=" + breg.path, "monitor_path=" + bstream]
    t0 = time.perf_counter()
    live = []                                  # (process, registry)
    clients = []
    try:
        # -- drive A: kill, heal, canary -------------------------------
        A = tier_proc(d, "tier_a", a_argv)
        live.append((A, areg))

        def a_ready():
            reps = areg.endpoints("replica")
            kinds = sorted(e["kind"] for e in reps)
            return reps if kinds == ["baseline", "baseline", "canary"] \
                and areg.endpoints("balancer") else None

        reps0 = tier_wait(a_ready, [A], "two replicas and the canary")
        a_up_s = time.perf_counter() - t0
        door_a = areg.endpoints("balancer")[0]
        started, a_stop = os.path.join(d, "a.started"), \
            os.path.join(d, "a.stop")
        cl = start_clients(d, "tier_a_drive", {
            "http_port": door_a["http_port"],
            "binary_port": door_a["binary_port"], "pool": pool_path,
            "swap": None, "http": True, "seconds": FLEET_TIMEOUT_S - 60,
            "until": a_stop, "model": "default", "started": started})
        clients.append(cl)
        tier_wait(lambda: os.path.exists(started), [A, cl],
                  "a first ok reply")
        time.sleep(TIER_KILL_AFTER_S)
        victim = next(e for e in reps0 if e["kind"] == "baseline")
        os.kill(int(victim["pid"]), signal.SIGKILL)
        t_kill = time.time()

        def healed():
            return [e for e in areg.endpoints("replica")
                    if e["kind"] == "baseline" and e["id"] != victim["id"]
                    and e["id"] not in {r["id"] for r in reps0}]

        tier_wait(healed, [A, cl], "a healed replica")
        tier_wait(lambda: os.path.exists(decision), [A, cl],
                  "the canary's decision")
        time.sleep(TIER_AFTER_S)
        a_gpu = on_card(areg.endpoints(), A["p"].pid)
        with open(a_stop, "w") as f:
            f.write("stop")
        drive_a = finish_clients(cl)
        clients.remove(cl)
        a_rc, a_child = stop_tier(A, areg)
        live.remove((A, areg))
        # -- drive B: the sharded front tier, a door killed ------------
        B = tier_proc(d, "tier_b", b_argv)
        live.append((B, breg))

        def b_ready():
            doors = breg.endpoints("balancer")
            return doors if len(doors) == 2 \
                and breg.endpoints("replica") else None

        doors0 = tier_wait(b_ready, [B], "two doors and a replica")
        # the spawned door serves once its registry sync saw the replica
        tier_wait(lambda: _door_ready(doors0[1]), [B],
                  "door b1's replica")
        started, b_stop = os.path.join(d, "b.started"), \
            os.path.join(d, "b.stop")
        cl = start_clients(d, "tier_b_drive", {
            "failover": [["127.0.0.1", e["binary_port"]] for e in doors0],
            "pool": pool_path, "until": b_stop, "model": "default",
            "started": started})
        clients.append(cl)
        tier_wait(lambda: os.path.exists(started), [B, cl],
                  "a first ok reply")
        time.sleep(TIER_KILL_AFTER_S)
        door = next(e for e in doors0 if e.get("pid"))
        os.kill(int(door["pid"]), signal.SIGKILL)
        t_door_kill = time.time()
        tier_wait(lambda: [e for e in breg.endpoints("balancer")
                           if e["id"] == door["id"]
                           and e["pid"] != door["pid"]], [B, cl],
                  "the door's respawn")
        time.sleep(TIER_AFTER_S)
        b_gpu = on_card(breg.endpoints(), B["p"].pid)
        with open(b_stop, "w") as f:
            f.write("stop")
        drive_b = finish_clients(cl)
        clients.remove(cl)
        b_rc, b_child = stop_tier(B, breg)
        live.remove((B, breg))
    finally:
        for cl in clients:
            if cl["p"].poll() is None:
                cl["p"].kill()
                cl["p"].wait()
            cl["err"].close()
        for proc, reg in live:
            stop_tier(proc, reg, limit=60.0)
    drive_s = time.perf_counter() - t0
    # the comparison sessions, after the drives: not the main path
    ref1 = ServeSession(cfg, model_path=snap1, device=DEVICE)
    ref2 = ServeSession(cfg, model_path=snap2, device=DEVICE)
    ladder = tuple(ref1.engine.buckets)
    refs = {"baseline": bucket_refs(ref1, pool, ladder),
            "canary": bucket_refs(ref2, pool, ladder)}
    for s in (ref1, ref2):
        s.close()
    torch.cuda.empty_cache()
    distinct = not same_bits(refs["baseline"][16], refs["canary"][16])
    arecs = read_jsonl(astream) if os.path.exists(astream) else []
    brecs = read_jsonl(bstream) if os.path.exists(bstream) else []
    with open(decision) as f:
        dec = json.load(f)
    canary_recs = [r for r in arecs if r["event"] == "canary"]
    scale_a = [r for r in arecs if r["event"] == "fleet_scale"]
    scale_b = [r for r in brecs if r["event"] == "fleet_scale"]
    promoted = dec.get("phase") == "promote"
    log_a = drive_a["log"]
    mine_a = [r for r in log_a if r["tenant"] != "free"]
    free = [r for r in log_a if r["tenant"] == "free"]
    shed = [r for r in free if r["status"] == 429]
    failed = [(r["proto"], r["status"], str(r["result"])[:160])
              for r in mine_a + drive_b["log"] if r["status"] != "ok"]
    served_a = attribute(mine_a, refs, ladder,
                         dec["t"] if promoted else None)
    served_b = attribute(drive_b["log"], refs, ladder)
    # the members: spawn to ready (the controller's replica_ready /
    # balancer_ready record), launches, nvcc, CUDA
    counts = dict(member_counts(adir), **{
        "b/" + k: v for k, v in member_counts(bdir).items()})
    ready_t = {}
    for tag, recs in (("", scale_a), ("b/", scale_b)):
        for r in recs:
            m = re.match(r"(?:replica|balancer) (\S+) \(pid", r["reason"])
            if r["action"] in ("replica_ready", "balancer_ready") and m:
                ready_t.setdefault(tag + m.group(1), []).append(r["t"])
    spawns = dict((a_child or {}).get("spawns", {}), **{
        "b/" + k: v for k, v in ((b_child or {}).get("spawns") or {}).items()})
    spawn_to_ready = {k: [r - s for s, r in zip(ts, ready_t.get(k, []))]
                      for k, ts in sorted(spawns.items())}
    launches = dict(NO_LAUNCHES)
    replicas = {}
    for mid, c in counts.items():
        if c["forwards"] == 0 and not any(c["launches"].values()):
            continue                                 # a door
        for k, v in c["launches"].items():
            launches[k] += v
        replicas[mid] = {
            "pid": c["pid"], "rc": c["rc"], "forwards": c["forwards"],
            "nvcc_runs": c["nvcc_runs"], "builds": c["builds"],
            "cuda": c["cuda_initialized"],
            "counted": c["forwards"] > 0 and c["launches"] == {
                k: v * c["forwards"] for k, v in BF16_LAUNCHES.items()}}
    doors = {mid: {"pid": c["pid"], "rc": c["rc"],
                   "cuda": c["cuda_initialized"]}
             for mid, c in counts.items() if mid not in replicas}
    gpu = {"a": a_gpu, "b": b_gpu}
    heal_s = next((r["t"] - t_kill for r in scale_a
                   if r["action"] == "replica_ready" and r["t"] > t_kill),
                  None)
    kill_b = [r for r in drive_b["log"] if r["t_send"] >= t_door_kill - 1.0
              and r["t_send"] <= t_door_kill + 5.0]
    wall_a = drive_a["t_end"] - drive_a["t0"]
    wall_b = drive_b["t_end"] - drive_b["t0"]
    fields_ok = sorted(dec) == sorted(
        ("event", "t", "phase", "baseline_version", "canary_version",
         "fraction", "reason", "window_s", "baseline", "canary"))
    res = {
        "phase": "fleet_tier", "model": "Inception-BN.conf",
        "config": "python -m cxxnet_tpu_torch.main tier.conf task=fleet "
                  "(Inception-BN.conf's net, dtype = bfloat16, %s, buckets "
                  "%s, serve_quota = %s) from the bundle phase's bundles; "
                  "A: fleet_replicas = 2, fleet_max_replicas = 3, "
                  "fleet_coalesce_ms = %g, fleet_coalesce_rows = %d, "
                  "fleet_shed_hi = %g, fleet_queue_hi = %g, canary_fraction = %g, canary_window_s = %g, "
                  "canary_min_requests = %d, canary_p99_ratio = %g; B: "
                  "fleet_replicas = 1, fleet_balancers = 2; clients in a "
                  "process of their own"
                  % (", ".join("%s = %s" % kv for kv in KNOBS),
                     ",".join(map(str, ladder)), FLEET_QUOTA,
                     TIER_COALESCE_MS, TIER_COALESCE_ROWS, TIER_SHED_HI,
                     TIER_QUEUE_HI, TIER_CANARY_FRACTION, TIER_CANARY_WINDOW_S,
                     TIER_CANARY_MIN, TIER_CANARY_P99_RATIO),
        "a_up_s": a_up_s, "drive_s": drive_s,
        "requests": len(mine_a) + len(drive_b["log"]),
        "n_failed": len(failed), "failed": failed[:10],
        "client_errors": (drive_a["errors"] + drive_b["errors"])[:5],
        "threads_alive": drive_a["alive"] + drive_b["alive"],
        "by_protocol": proto_stats(mine_a, wall_a, ("http", "cxn1", "cxn2")),
        "rows_per_s": sum(r["n"] for r in mine_a
                          if r["status"] == "ok") / wall_a,
        "direct_binary": fres.get("binary_only"),
        "doors": {"by_protocol": proto_stats(drive_b["log"], wall_b,
                                             ("cxn1",)),
                  "failovers": drive_b["failovers"],
                  "gap_ms": max((r["ms"] for r in kill_b), default=None),
                  "killed": door["id"]},
        "snapshots_distinct": distinct, "served_by": served_a,
        "served_by_doors": served_b,
        "quota": {"free_requests": len(free), "over_quota_429": len(shed),
                  "typed": all(r["result"].get("error") == "over_quota"
                               and r["extra"] for r in shed)},
        "canary": {"decision": {k: dec.get(k) for k in (
                       "phase", "reason", "baseline_version",
                       "canary_version", "baseline", "canary")},
                   "fields_as_reference": fields_ok,
                   "valid": validate_record(dec) == [],
                   "records": [r["phase"] for r in canary_recs]},
        "scale_a": [(r["action"], round(r["t"] - t_kill, 3))
                    for r in scale_a],
        "scale_b": [r["action"] for r in scale_b],
        "heal_s": heal_s, "spawn_to_ready_s": spawn_to_ready,
        "replicas": replicas, "fleet_doors": doors, "gpu": gpu,
        "fleet_processes": {"a": {"rc": a_rc, "child": a_child},
                            "b": {"rc": b_rc, "child": b_child}},
        "launches": launches,
        "schema_errors": (validate_records(arecs, strict=False)
                          + validate_records(brecs, strict=False))[:5]}
    res["ok"] = bool(
        not failed and not res["client_errors"] and not res["threads_alive"]
        and distinct and promoted and fields_ok and res["canary"]["valid"]
        and res["canary"]["records"][:1] == ["start"]
        and served_a["neither"] == 0 and served_a["late_other"] == 0
        and served_a["baseline"] > 0 and served_a["canary"] > 0
        and served_b["neither"] == 0 and served_b["baseline"] > 0
        and shed and res["quota"]["typed"]
        and [a for a, t in res["scale_a"] if t > 0][:2]
        == ["replica_lost", "replica_ready"] and heal_s is not None
        and "balancer_lost" in res["scale_b"]
        and sum(drive_b["failovers"]) > 0
        and all(g["replicas_on_card"] and g["others_off_card"]
                for g in gpu.values())
        and a_child and b_child and not a_child["cuda_initialized"]
        and not b_child["cuda_initialized"] and a_rc == 0 and b_rc == 0
        and len(replicas) >= 4
        and all(r["counted"] and r["nvcc_runs"] == 0 and r["rc"] == 0
                and r["cuda"] for r in replicas.values())
        and doors and all(not o["cuda"] and o["rc"] == 0
                          for o in doors.values())
        and not res["schema_errors"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("fleet_tier phase failed")
    return res


def _door_ready(door) -> bool:
    """Whether the door's ``/healthz`` counts a ready replica."""
    import http.client
    try:
        conn = http.client.HTTPConnection("127.0.0.1", door["http_port"],
                                          timeout=5)
        try:
            conn.request("GET", "/healthz")
            h = json.loads(conn.getresponse().read())
        finally:
            conn.close()
    except (OSError, ValueError):
        return False                     # not listening yet
    return h.get("ready", 0) >= 1


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
            kernel_device_ms=sec["step_sum"]["%s_device_ms" % sfx],
            bound_share=sec["step_sum"]["%s_bound_ms" % sfx]
            / sec["step_sum"]["%s_device_ms" % sfx],
            routes=sec["%s_routes" % sfx],
            main_path_routes=[r["route"] for r in run["bwd_routes"]]
            if sfx == "bwd" else None,
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
             library_device_ms=bias["step_sum"]["library_device_ms"],
             library=bias["library"],
             chain_bound_ms=bias["step_sum"]["chain_bound_ms"],
             chain_adds=bias["chain_per_step"],
             add_ns=kres["bf16_add"]["ns_per_add"],
             add_cycles=kres["bf16_add"]["cycles_per_add"],
             kernel_device_ms=bias["step_sum"]["device_ms"],
             routes=[[c["shape"], c["routes"], c["groups"]]
                     for c in bias["cases"]],
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
    stamps = [(phase, time.perf_counter())]     # each phase's start
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        from cxxnet_tpu_torch.device import resolve_device
        resolve_device("cuda")           # TF32 off before any product
        smi = phase_env()
        bw, flops, part = card_peaks(torch.cuda.get_device_name(0))
        phase = "kernels"
        stamps.append((phase, time.perf_counter()))
        kres = phase_kernels(bw, flops, bf16_tc_peak(part))
        phase = "serve"
        stamps.append((phase, time.perf_counter()))
        sres = phase_serve(workdir)
        phase = "serve_lowp"
        stamps.append((phase, time.perf_counter()))
        lres = phase_serve_lowp(workdir, kres)
        phase = "train"
        stamps.append((phase, time.perf_counter()))
        tres = phase_train(workdir)
        phase = "train_bf16"
        stamps.append((phase, time.perf_counter()))
        tbres = phase_train_bf16(workdir, tres["step_ms"])
        phase = "train_kaiming"
        stamps.append((phase, time.perf_counter()))
        kmres = phase_train_kaiming(workdir)
        phase = "tower"
        stamps.append((phase, time.perf_counter()))
        twres = phase_tower(workdir)
        phase = "cli"
        stamps.append((phase, time.perf_counter()))
        clires = phase_cli(workdir)
        phase = "alexnet"
        stamps.append((phase, time.perf_counter()))
        alexres = phase_alexnet(workdir, bw)
        phase = "checkpoint"
        stamps.append((phase, time.perf_counter()))
        ckres = phase_checkpoint(workdir)
        phase = "wrapper"
        stamps.append((phase, time.perf_counter()))
        wres = phase_wrapper(workdir)
        phase = "fleet"
        stamps.append((phase, time.perf_counter()))
        fres = phase_fleet(workdir)
        phase = "capi"
        stamps.append((phase, time.perf_counter()))
        cres = phase_capi(workdir)
        phase = "bundle"
        stamps.append((phase, time.perf_counter()))
        bres = phase_bundle(workdir)
        phase = "continual"
        stamps.append((phase, time.perf_counter()))
        cnres = phase_continual(workdir)
        phase = "fleet_tier"
        stamps.append((phase, time.perf_counter()))
        ftres = phase_fleet_tier(workdir, fres)
    except Exception as e:
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": "%s: %s" % (type(e).__name__, e)})
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    stamps.append(("end", time.perf_counter()))
    emit({"phase_seconds": dict({a[0]: b[1] - a[1]
                                 for a, b in zip(stamps, stamps[1:])},
                                all=stamps[-1][1] - stamps[0][1])})
    kl = kernels_line(kres, sres, lres, tres, tbres, kmres, twres, part)
    for row in kl["kernels"]:
        # the cli phase's runs (train, pred, pred_raw, serve), each with
        # the counts set to 0 just before it, the alexnet phase's
        # training run
        row["cli_launches"] = clires["launches"][row["name"]]
        row["alexnet_launches"] = alexres["launches"][row["name"]]
        # the checkpoint phase's runs (the preempted subprocess, resume,
        # quarantine, retention, fault://, finetune and its pred, the
        # channel_pad and precompile updates), each from 0
        row["checkpoint_launches"] = ckres["launches"][row["name"]]
        # the wrapper phase's main path: its updates, evaluate, predict
        # and extract, from 0
        row["wrapper_launches"] = wres["launches"][row["name"]]
        # the fleet phase's main path (boot, traffic, the hot-swap's
        # shadow build) and the C ABI's updates, predict and extract,
        # each from 0
        row["fleet_launches"] = fres["launches"][row["name"]]
        row["capi_launches"] = cres["launches"][row["name"]]
        # the bundle phase's runs (the export, pred / pred_raw / serve from
        # the bundle, both cold starts, the hot-swap fleet) and the
        # continual phase's two loops (updates, gate evals, exports, the
        # fleet's boots, shadow builds and traffic), each from 0
        row["bundle_launches"] = bres["launches"][row["name"]]
        row["continual_launches"] = cnres["launches"][row["name"]]
        # the fleet tier's replica processes (boots, warmups, traffic,
        # the heal, the canary and the promote's roll), each from 0 at
        # its start, summed over those that drained (a SIGKILLed one
        # reports nothing)
        row["fleet_tier_launches"] = ftres["launches"][row["name"]]
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
                "library_device_ms": ab["step_sum"]["library_device_ms"],
                "chain_bound_ms": ab["step_sum"]["chain_bound_ms"],
                "chain_adds": ab["chain_per_step"],
                "kernel_device_ms": ab["step_sum"]["device_ms"],
                "device_ms": alexres["profile"]["bias_grad_device_ms"],
                "cases": [{k: c[k] for k in ("shape", "count", "ms",
                                             "device_ms", "plain_ms",
                                             "bound_ms", "chain_bound_ms",
                                             "library_ms",
                                             "library_device_ms", "routes",
                                             "groups", "exact")}
                          for c in ab["cases"]]}
    emit(kl)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
