#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (cxxnet_tpu_torch/).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase prints ``"ok": false`` and
the script exits non-zero without a result line):

1. env     — the card (``nvidia-smi`` name and power limit), torch and
             CUDA versions, and the ``nvcc`` build of every kernel of
             the serve path from ``cxxnet_tpu_torch/csrc/``.
2. kernels — each kernel against its plain PyTorch version on the card,
             at every shape the served Inception-BN-224 gives it at
             bucket 128, plus dtype, layout and ragged-channel cases:
             max error, kernel / plain / library times (CUDA events)
             and the bound from bytes and operations.
3. serve   — Inception-BN-224 (1000 classes, random weights from a seed,
             realistic BN running stats) saved as a snapshot, served
             through ``ServeSession(device="cuda")`` to closed-loop
             clients and one full-bucket burst; launch counts show the
             path went through the kernels; 4 rows are held against the
             port on the CPU.

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
    path = kernels.build_kernel("conv_epilogue")
    build_s = time.perf_counter() - t0
    log = kernels.build_info["conv_epilogue"]["log"]
    ptxas = [ln.strip() for ln in str(log).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "env", "ok": True, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build": {"conv_epilogue": os.path.relpath(path),
                    "seconds": round(build_s, 3), "ptxas": ptxas[:8]}})
    return smi


# ------------------------------------------------------------- phase 2


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
    dev = torch.device("cuda")
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


def phase_kernels(bw: float, flops: float):
    import torch
    from cxxnet_tpu_torch.graph import NetGraph
    from cxxnet_tpu_torch.nnet.net import FuncNet
    g = NetGraph()
    g.configure(inception_cfg())
    net = FuncNet(g, MAX_BATCH)
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
           "extra_cases": extra}
    emit(res)
    if not ok:
        raise RuntimeError("conv_epilogue disagrees with its plain version")
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
                nodes = net.forward(trainer.params, trainer.net_state, data)
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
        smi = phase_env()
        bw, flops, part = card_peaks(torch.cuda.get_device_name(0))
        phase = "kernels"
        kres = phase_kernels(bw, flops)
        phase = "serve"
        sres = phase_serve(workdir)
    except Exception as e:
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": "%s: %s" % (type(e).__name__, e)})
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    fwd = kres["forward_sum"]
    emit({"kernels": [dict(
        EPILOGUE, launches=sres["conv_epilogue_launches"],
        max_abs_err=kres["max_abs_err"], ms=fwd["ms"],
        plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
        bound_by=kres["bound_by"], library_ms=None,
        device_ms=sres["profile"]["epilogue_device_ms"],
        per="one forward at bucket 128: %d launches"
        % kres["path_launches_per_forward"],
        peaks=part)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
