#!/usr/bin/env python
"""Closed-loop serve benchmark over the port's serving stack
(counterpart of the repo-root ``tools/serve_bench.py``): client sweep
over the serve subsystem.

Drives N threaded closed-loop clients (each waits for its result before
sending the next request) through a ``ServeSession`` and reports one
BENCH-style JSON record on stdout: per-sweep-point request throughput,
latency p50/p99, micro-batch fill rate and pad fraction — all read back
from the schema-validated ``serve_*`` telemetry records rather than
re-derived timers (the bench rule), plus a ``zero_recompiles`` verdict
(no compile event after warmup at any sweep point).

A compile event here is what the port pays at first use where the
reference compiles an XLA program: a kernel library built by ``nvcc``
(``layers.kernels.nvcc_runs``), a first dispatch at a bucket the warmup
did not run (the engine's ``compile_events``), or a ``compile`` record
of any kind but the warmup's own ``precompile``. A bundle whose
fingerprint matches boots with none.

Default is a self-contained synthetic MLP on the GPU (``--dev cpu`` for
the CPU smoke run; without a GPU and without it the tool raises); pass
``--conf``/``--model-in`` to sweep a real snapshot instead.

``--tenants`` switches to the closed-loop **multi-tenant fleet
scenario**: per-tenant client mixes with token-bucket quotas driven
through the real binary-protocol front end (``serve/frontend.py``) —
per-tenant ok/shed counts, shed rate, and latency p50/p99 read back
from the ``serve_http`` records, plus a p99-SLO assertion:
``--slo-p99-ms`` makes the process exit 3 (distinct from 1 =
post-warmup recompiles; argparse owns 2 — the bench exit-code
convention) when any tenant's ok-request p99 breaches the SLO. The
point of quota shedding is that *surviving* requests stay fast — the
SLO applies to every tenant's completed requests, shed or not.

Usage::

    python -m cxxnet_tpu_torch.tools.serve_bench --dev cpu --clients 1,2,4,8
    python -m cxxnet_tpu_torch.tools.serve_bench --conf run.conf \
        --model-in 0010.model.npz
    python -m cxxnet_tpu_torch.tools.serve_bench --dev cpu \
        --tenants gold:4,free:4:50:8 --slo-p99-ms 250
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SYNTH_CONF = """
netconfig=start
layer[+1:h] = fullc:fc1
  nhidden = 64
  init_sigma = 0.05
layer[+1] = relu
layer[h->o] = fullc:fc2
  nhidden = 10
  init_sigma = 0.05
layer[+0] = softmax
netconfig=end
input_shape = 1,1,256
batch_size = 32
eta = 0.1
"""


def _device(args) -> str:
    """The torch device type ``--dev`` names: ``cuda`` for ``gpu``."""
    return "cpu" if args.dev == "cpu" else "cuda"


def build_session(args, monitor, via: str = ""):
    """``via`` selects the boot source when both are configured:
    "artifact" (the sealed bundle), "snapshot" (--conf/--model-in),
    or "" = artifact when given, else snapshot/synthetic."""
    from cxxnet_tpu_torch.serve import InferenceEngine, ServeSession
    from cxxnet_tpu_torch.utils.config import parse_config, parse_config_file
    serve_pairs = [
        ("serve_buckets", args.buckets),
        ("serve_max_delay_ms", str(args.max_delay_ms)),
        ("serve_queue_rows", str(args.queue_rows)),
    ]
    if args.serve_dtype:
        serve_pairs.append(("serve_dtype", args.serve_dtype))
    if args.serve_weight_residency:
        serve_pairs.append(("serve_weight_residency",
                            args.serve_weight_residency))
    if args.artifact and via != "snapshot":
        # conf-less boot: the serve contract (bucket ladder, dtype,
        # node, max batch) comes from the sealed manifest; explicit
        # CLI knobs appended after it still win
        from cxxnet_tpu_torch.artifact.bundle import serve_cfg_from_bundle
        cfg = serve_cfg_from_bundle(args.artifact) + serve_pairs
        return ServeSession(cfg, model_path=args.artifact,
                            monitor=monitor, device=_device(args))
    if args.conf:
        cfg = parse_config_file(args.conf) + serve_pairs
        assert args.model_in, "--conf needs --model-in"
        return ServeSession(cfg, model_path=args.model_in,
                            monitor=monitor, device=_device(args))
    # synthetic: random weights are fine — serving cost does not depend
    # on what the weights converged to
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    cfg = parse_config(SYNTH_CONF) + serve_pairs
    trainer = NetTrainer(cfg, device=_device(args))
    trainer.init_model()
    trainer.set_monitor(monitor)
    from cxxnet_tpu_torch.serve.bucketing import parse_buckets
    from cxxnet_tpu_torch.serve.engine import input_dtype_for
    engine = InferenceEngine(
        trainer, buckets=parse_buckets(args.buckets, 32),
        input_dtype=input_dtype_for(args.serve_dtype))
    return ServeSession(cfg, engine=engine, monitor=monitor)


def sweep_point(args, clients, monitor, sink):
    """One sweep point = one fresh session (clean counters and
    telemetry), ``clients`` closed-loop clients, stats read back from
    the emitted records."""
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.monitor.schema import validate_records
    from cxxnet_tpu_torch.serve import run_closed_loop
    sink.clear()
    session = build_session(args, monitor)
    nvcc = kernels.nvcc_runs
    rng = np.random.RandomState(0)
    inst = session.engine._inst_shape()
    pool = rng.uniform(0, 1, size=(256,) + inst).astype(np.float32)
    agg = run_closed_loop(session, pool, clients, args.requests,
                          args.request_rows)
    summary = session.close()
    errs = validate_records(sink.records)
    assert not errs, "schema-invalid serve telemetry: %s" % errs[:5]
    batches = [r for r in sink.records if r["event"] == "serve_batch"]
    pt = {
        "clients": clients,
        "requests_ok": agg["ok"],
        "requests_busy": agg["busy"],
        "requests_error": agg["error"] + agg["timeout"],
        "rows_per_sec": round(agg["rows_per_sec"], 2),
        "latency_p50_ms": summary["latency_p50_ms"],
        "latency_p99_ms": summary["latency_p99_ms"],
        "fill_rate": round(summary["fill_rate"], 4),
        "pad_fraction": round(summary["pad_fraction"], 4),
        "batches": summary["batches"],
        "mean_rows_per_batch": round(
            summary["rows"] / max(1, summary["batches"]), 2),
        # first dispatches at an unwarmed bucket, and kernel libraries
        # built after the warmup
        "compile_events": summary["compile_events"]
        + kernels.nvcc_runs - nvcc,
        "serve_batch_records": len(batches),
    }
    mfu = serve_mfu(sink.records, agg["rows_per_sec"],
                    args.peak_tflops)
    if mfu is not None:
        pt["mfu"] = mfu
    if args.device_mem:
        # per-model resident device bytes from the weight_residency
        # record the freeze emitted during this point's session build
        res = [r for r in sink.records
               if r["event"] == "weight_residency"]
        pt["device_mem_bytes"] = res[-1]["bytes"] if res else 0
        if res:
            pt["residency_quantize_ms"] = round(
                res[-1]["quantize_ms"], 3)
    return pt


def _compile_records(records):
    """A stream's compile events: its ``compile`` records of kind
    ``first`` or ``recompile``. The warmup's ``precompile`` records run
    each bucket once, from a bundle as from a snapshot: the reference's
    warmup compiles nothing from a bundle, and emits none there."""
    return [r for r in records if r.get("event") == "compile"
            and r.get("kind") != "precompile"]


def measure_cold_start(args, monitor, sink, via):
    """Cold-start column: boot a FRESH session (load + program
    acquisition + warmup) and time to the first served reply, with
    the compile count over the whole window read from the telemetry
    stream — the artifact win lands in a bench record, not a claim.
    ``via`` = "artifact" boots the sealed bundle, "snapshot" the
    --conf/--model-in pair (the re-compile baseline column). The
    compile count is the kernel libraries ``nvcc`` built in the window
    plus its ``compile`` records of kind ``first`` or ``recompile``
    (the warmup's ``precompile`` records run every bucket once, from a
    bundle as from a snapshot)."""
    from cxxnet_tpu_torch.layers import kernels
    sink.clear()
    nvcc = kernels.nvcc_runs
    t0 = time.perf_counter()
    session = build_session(args, monitor, via=via)
    boot_s = time.perf_counter() - t0
    inst = session.engine._inst_shape()
    t1 = time.perf_counter()
    session.predict(np.zeros((1,) + inst, np.float32))
    first_reply_ms = (time.perf_counter() - t1) * 1e3
    session.close()
    compiles = _compile_records(sink.records)
    art = next((r for r in sink.records
                if r["event"] == "artifact_load"), None)
    col = {
        "via": via,
        "source": args.artifact if via == "artifact"
        else args.model_in,
        "boot_s": round(boot_s, 3),
        "first_reply_ms": round(first_reply_ms, 3),
        "time_to_first_reply_s": round(boot_s + first_reply_ms / 1e3,
                                       3),
        "compile_events": len(compiles) + kernels.nvcc_runs - nvcc,
        "warmup_programs": int(session.warmup_programs),
    }
    if art is not None:
        col["artifact_hits"] = art["hits"]
        col["artifact_rebuilds"] = art["rebuilds"]
        col["fingerprint_match"] = art["fingerprint_match"]
    return col


def serve_mfu(records, rows_per_sec, peak_tflops):
    """Serve-side MFU from telemetry: the analytic forward FLOPs ride
    in the ``model_info`` record the engine's trainer emits, so serve
    and train MFU columns come from the same denominator (bench.py's
    --peak-tflops plumbing, doc/perf_profile.md "MFU bookkeeping").
    Eval is forward-only: flops_per_example, not the 3x train count."""
    if peak_tflops <= 0:
        return None
    flops = next((r["flops_per_example"] for r in records
                  if r["event"] == "model_info"), 0.0)
    if flops <= 0:
        return None
    return round(rows_per_sec * flops / (peak_tflops * 1e12), 6)


def parse_tenants(spec):
    """``name:clients[:rate[:burst]]`` comma list -> list of dicts
    (rate 0/absent = unlimited; burst defaults to the rate)."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                "tenant spec %r must be name:clients[:rate[:burst]]"
                % entry)
        out.append({
            "tenant": parts[0],
            "clients": int(parts[1]),
            "rate": float(parts[2]) if len(parts) > 2 else 0.0,
            "burst": float(parts[3]) if len(parts) > 3
            else (float(parts[2]) if len(parts) > 2 else 0.0),
        })
    if not out:
        raise ValueError("empty --tenants spec")
    return out


def run_multi_tenant(args, monitor, sink):
    """The closed-loop multi-tenant fleet scenario: every tenant's
    clients drive the real binary-protocol front end; quotas shed the
    over-quota mix with the typed reply; stats come back from the
    schema-validated ``serve_http`` records. Returns (record,
    slo_ok, zero_recompiles)."""
    import tempfile
    import threading

    from cxxnet_tpu_torch.monitor.schema import validate_records
    from cxxnet_tpu_torch.serve import BinaryClient, FleetServer
    from cxxnet_tpu_torch.utils.config import parse_config, parse_config_file

    tenants = parse_tenants(args.tenants)
    quota = ",".join("%s:%g:%g" % (t["tenant"], t["rate"], t["burst"])
                     for t in tenants if t["rate"] > 0)
    serve_pairs = [
        ("serve_buckets", args.buckets),
        ("serve_max_delay_ms", str(args.max_delay_ms)),
        ("serve_queue_rows", str(args.queue_rows)),
        ("serve_dtype", args.serve_dtype or "float32"),
        ("serve_http_port", "-1"),
        ("serve_binary_port", "0"),
        ("serve_swap_poll_s", "0"),
        ("dev", args.dev),
    ]
    if quota:
        serve_pairs.append(("serve_quota", quota))
    sink.clear()
    with tempfile.TemporaryDirectory() as td:
        if args.conf:
            assert args.model_in, "--conf needs --model-in"
            cfg = parse_config_file(args.conf)
            model_src = args.model_in
        else:
            from cxxnet_tpu_torch.nnet.trainer import NetTrainer
            cfg = parse_config(SYNTH_CONF)
            trainer = NetTrainer(cfg, device=_device(args))
            trainer.init_model()
            model_src = os.path.join(td, "0001.model.npz")
            trainer.save_model(model_src)
        fleet = FleetServer(
            cfg + serve_pairs + [("serve_models",
                                  "bench=%s" % model_src)],
            monitor=monitor)
        fleet.start()
        inst = fleet.router.resolve("bench").session.engine \
            ._inst_shape()
        rng = np.random.RandomState(0)
        pool = rng.uniform(0, 1, size=(256,) + inst) \
            .astype(np.float32)
        counts = {t["tenant"]: {"ok": 0, "shed": 0, "errors": 0}
                  for t in tenants}
        lock = threading.Lock()
        t0 = time.time()

        def client(tenant, ci):
            bc = BinaryClient("127.0.0.1", fleet.binary_port)
            try:
                for r in range(args.requests):
                    start = (ci * args.requests + r) \
                        * args.request_rows % 256
                    rows = np.take(
                        pool, range(start, start + args.request_rows),
                        axis=0, mode="wrap")
                    try:
                        status, _ = bc.predict(rows, tenant=tenant)
                    except Exception:
                        # dead transport (socket timeout, dropped
                        # connection): the requests this client never
                        # completed must show up as errors, not
                        # silently shrink the sample the SLO gate
                        # reads
                        with lock:
                            counts[tenant]["errors"] += \
                                args.requests - r
                        break
                    with lock:
                        if status == "ok":
                            counts[tenant]["ok"] += 1
                        elif status in ("over_quota", "busy"):
                            counts[tenant]["shed"] += 1
                        else:
                            counts[tenant]["errors"] += 1
            finally:
                bc.close()

        threads = [threading.Thread(target=client,
                                    args=(t["tenant"], ci))
                   for t in tenants for ci in range(t["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        summary = fleet.close()
    errs = validate_records(sink.records)
    assert not errs, "schema-invalid fleet telemetry: %s" % errs[:5]
    ok_lat = {}
    for r in sink.records:
        if r["event"] == "serve_http" and r["status"] == "ok":
            ok_lat.setdefault(r["tenant"], []).append(r["latency_ms"])
    rows_out, slo_ok = [], True
    for t in tenants:
        name = t["tenant"]
        c = counts[name]
        lat = sorted(ok_lat.get(name, []))

        def pct(q):
            return round(lat[min(len(lat) - 1,
                                 int(q * len(lat)))], 3) if lat else 0.0

        p99 = pct(0.99)
        total = c["ok"] + c["shed"] + c["errors"]
        breach = bool(args.slo_p99_ms and lat
                      and p99 > args.slo_p99_ms)
        slo_ok = slo_ok and not breach
        rows_out.append({
            "tenant": name, "clients": t["clients"],
            "rate": t["rate"], "burst": t["burst"],
            "requests_ok": c["ok"], "requests_shed": c["shed"],
            "requests_error": c["errors"],
            "shed_rate": round(c["shed"] / total, 4) if total else 0.0,
            "latency_p50_ms": pct(0.50), "latency_p99_ms": p99,
            "rows_per_sec": round(
                c["ok"] * args.request_rows / wall, 2),
            "slo_breach": breach,
        })
        print("# tenant=%s: %d ok / %d shed (rate %.2f), p50 %.2f ms"
              ", p99 %.2f ms%s"
              % (name, c["ok"], c["shed"], rows_out[-1]["shed_rate"],
                 rows_out[-1]["latency_p50_ms"], p99,
                 " SLO-BREACH" if breach else ""), file=sys.stderr)
    zero_recompiles = all(
        m.get("compile_events", 0) == 0
        for m in summary["models"].values())
    total_rps = sum(r["rows_per_sec"] for r in rows_out)
    rec = {
        "name": "serve_bench",
        "mode": "multi_tenant",
        "t": time.time(),
        "model": args.conf or "synthetic_mlp_256_64_10",
        "dtype": args.serve_dtype or "float32",
        "buckets": args.buckets,
        "max_delay_ms": args.max_delay_ms,
        "requests_per_client": args.requests,
        "request_rows": args.request_rows,
        "wall_s": round(wall, 2),
        "slo_p99_ms": args.slo_p99_ms,
        "slo_ok": slo_ok,
        "tenants": rows_out,
        "zero_recompiles": zero_recompiles,
        "quota": summary["quota"],
    }
    mfu = serve_mfu(sink.records, total_rps, args.peak_tflops)
    if mfu is not None:
        rec["mfu"] = mfu
    return rec, slo_ok, zero_recompiles


# -- continual train-while-serve soak (--generations) ---------------------


def _write_soak_idx(td, n=300, d=16, nclass=4, seed=0, name=""):
    """Learnable synthetic idx dataset (class k lights up image block
    k): the continual soak needs training that actually improves so
    the eval gate has something real to pass."""
    import struct
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, nclass, size=(n,)).astype(np.uint8)
    img = rng.randint(0, 60, size=(n, d, d), dtype=np.uint8)
    blk = d // nclass
    for i in range(n):
        k = lab[i]
        img[i, :, k * blk:(k + 1) * blk] = np.minimum(
            img[i, :, k * blk:(k + 1) * blk] + 180, 255)
    pimg = os.path.join(td, "img%s.idx3" % name)
    plab = os.path.join(td, "lab%s.idx1" % name)
    with open(pimg, "wb") as f:
        f.write(struct.pack(">iiii", 0x803, n, d, d))
        f.write(img.tobytes())
    with open(plab, "wb") as f:
        f.write(struct.pack(">ii", 0x801, n))
        f.write(lab.tobytes())
    return pimg, plab


SOAK_NET = """
netconfig=start
layer[+1:h] = fullc:fc1
  nhidden = 32
  init_sigma = 0.05
layer[+1] = relu
layer[h->o] = fullc:fc2
  nhidden = 4
  init_sigma = 0.05
layer[+0] = softmax
netconfig=end
input_shape = 1,1,256
batch_size = 50
eta = 0.1
momentum = 0.9
metric[label] = error
"""


def run_continual_soak(args, monitor, sink):
    """``--generations N``: the continual train-while-serve
    acceptance soak (doc/continual.md). One process trains while its
    fleet serves; closed-loop binary clients hammer it across every
    hot-swap. Returns (record, clean, zero_recompiles):

    - ``clean`` is False (exit 3) on ANY dropped/failed client
      request, a generation that did not deploy+flip, or a
      non-monotone gated eval across deployed generations;
    - ``zero_recompiles`` is False (exit 1) on any post-warmup
      compile on a serving engine (swapped-in engines included).
    """
    import tempfile
    import threading

    from cxxnet_tpu_torch.continual import ContinualLoop
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.monitor.schema import validate_records
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import BinaryClient
    from cxxnet_tpu_torch.utils.config import parse_config

    n_gen = int(args.generations)
    sink.clear()
    with tempfile.TemporaryDirectory() as td:
        pimg, plab = _write_soak_idx(td, n=300, name="tr")
        pimg2, plab2 = _write_soak_idx(td, n=100, seed=5, name="te")
        model_dir = os.path.join(td, "models")
        cfg = parse_config(SOAK_NET) + [
            ("continual_generations", str(n_gen)),
            ("continual_export_every", "6"),
            ("continual_gate_eps", "0.05"),
            ("continual_linger_s", "3"),
            ("serve_buckets", args.buckets if args.buckets != "auto"
             else "1,4"),
            ("serve_max_batch", "4"),
            ("serve_max_delay_ms", str(args.max_delay_ms)),
            ("serve_http_port", "-1"),
            ("serve_binary_port", "0"),
            ("serve_swap_poll_s", "30"),   # the notify() kick, not
            #                                the poll, drives swaps
            ("silent", "1"),
        ]
        batch_cfg = [("batch_size", "50"),
                     ("input_shape", "1,1,256")]
        itr_train = create_iterator(
            [("iter", "mnist"), ("path_img", pimg),
             ("path_label", plab), ("shuffle", "1"), ("silent", "1")],
            batch_cfg)
        itr_train.init()
        itr_eval = create_iterator(
            [("iter", "mnist"), ("path_img", pimg2),
             ("path_label", plab2), ("silent", "1")], batch_cfg)
        itr_eval.init()
        trainer = NetTrainer(cfg, device=_device(args))
        trainer.set_monitor(monitor)
        trainer.init_model()

        deployed_done = threading.Event()
        ngen_seen = {"deployed": 0}

        def on_generation(rec):
            if rec.get("action") == "deployed":
                ngen_seen["deployed"] += 1
                if ngen_seen["deployed"] >= n_gen:
                    deployed_done.set()  # stop clients inside linger

        loop = ContinualLoop(
            cfg, trainer, itr_train, [("test", itr_eval)],
            model_dir=model_dir,
            path_for=lambda c: os.path.join(
                model_dir, "%04d.model.npz" % c),
            monitor=monitor, on_generation=on_generation,
            dispatch_period=3)
        summary = {}

        def run_loop():
            summary.update(loop.run())

        lt = threading.Thread(target=run_loop, name="continual-loop")
        lt.start()

        # clients come up once generation 1 boots the fleet
        deadline = time.time() + 600
        while time.time() < deadline and lt.is_alive() \
                and (loop.fleet is None or loop.fleet.binary_port <= 0):
            time.sleep(0.05)
        counts = {"ok": 0, "shed": 0}
        failures = []
        lock = threading.Lock()
        clients = []
        if loop.fleet is not None and loop.fleet.binary_port > 0:
            port = loop.fleet.binary_port
            rng = np.random.RandomState(0)
            pool = rng.rand(16, 256).astype(np.float32)

            def client(ci):
                bc = BinaryClient("127.0.0.1", port, timeout=120)
                try:
                    while not deployed_done.is_set():
                        rows = pool[(ci * 3) % 12:(ci * 3) % 12
                                    + args.request_rows]
                        try:
                            status, out = bc.predict(rows)
                        except Exception as e:
                            with lock:
                                failures.append(repr(e))
                            return
                        with lock:
                            if status == "ok":
                                counts["ok"] += 1
                            elif status in ("busy", "over_quota"):
                                counts["shed"] += 1
                            else:
                                failures.append((status, out))
                finally:
                    bc.close()

            clients = [threading.Thread(target=client, args=(i,))
                       for i in range(3)]
            for t in clients:
                t.start()
        lt.join(timeout=600)
        deployed_done.set()
        for t in clients:
            t.join(timeout=120)
        alive = lt.is_alive()

    errs = validate_records(sink.records)
    assert not errs, "schema-invalid continual telemetry: %s" % errs[:5]
    gens = [r for r in sink.records if r["event"] == "generation"]
    deployed = [r for r in gens if r["action"] == "deployed"]
    vals = [r["value"] for r in deployed]
    eps = 0.05
    monotone = all(b <= a + eps for a, b in zip(vals, vals[1:]))
    # the loop's rollup already folds every engine's final counter
    # (swapped-in engines included) exactly once — the per-record
    # swap_compile_events are point-in-time samples of the same
    # counters, not an additional total
    serve_compiles = int(summary.get("serve_compile_events", 0))
    clean = (not alive and not failures
             and len(deployed) == n_gen and monotone
             and int(summary.get("swaps", 0)) == n_gen - 1)
    rec = {
        "name": "serve_bench", "mode": "continual", "t": time.time(),
        "model": "synthetic_mlp_256_32_4",
        "generations": n_gen,
        "generations_deployed": len(deployed),
        "gate_skipped": int(summary.get("gate_skipped", 0)),
        "hot_swaps": int(summary.get("swaps", 0)),
        "train_updates": int(summary.get("updates", 0)),
        "eval_values": [round(v, 5) for v in vals],
        "eval_monotone": monotone,
        "requests_ok": counts["ok"],
        "requests_shed": counts["shed"],
        "requests_failed": len(failures),
        "wall_s": round(float(summary.get("wall_s", 0.0)), 2),
        "zero_failed_requests": not failures,
        "zero_recompiles": serve_compiles == 0,
    }
    for g in deployed:
        print("# generation %d: %s=%.4f, %s, swap compiles %d"
              % (g["generation"], g["metric"], g["value"],
                 "boot" if g.get("boot") else
                 "hot-swap %.2fs" % g.get("swap_wall_s", 0.0),
                 g.get("swap_compile_events", 0)), file=sys.stderr)
    print("# continual soak: %d/%d deployed, %d swaps, %d ok / %d "
          "shed / %d failed, monotone=%s, serve compiles %d"
          % (len(deployed), n_gen, rec["hot_swaps"], counts["ok"],
             counts["shed"], len(failures), monotone, serve_compiles),
          file=sys.stderr)
    return rec, clean, serve_compiles == 0


# -- retrieval scenario (--embed-search) ----------------------------------


EMBED_NET = """
netconfig=start
layer[+1:h] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1] = relu
layer[h->o] = fullc:fc2
  nhidden = 8
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 16
eta = 0.1
"""


def run_embed_search(args, monitor, sink):
    """``--embed-search``: the retrieval product closed-loop
    (doc/retrieval.md). Builds a sealed indexed bundle via
    ``task=build_index``, boots a fleet from it, and drives three
    scenarios through the binary protocol's op-suffix grammar:
    embed-only (``#embed``), search-only (``#search:k``), and the
    fanned embed->search composition (``#fsearch:k``). Returns
    (record, clean, zero_recompiles):

    - ``clean`` is False (exit 3) on ANY failed request, an invalid
      telemetry stream, or a recall spot-check that disagrees with
      the NumPy oracle over the sealed index (exact search: served
      top-k ids must match id-for-id);
    - ``zero_recompiles`` is False (exit 1) on any post-warmup
      compile — predict OR search program books, a ``compile``
      record of kind ``first`` or ``recompile`` anywhere in the stream,
      or a kernel library built after the boot.
    """
    import tempfile
    import threading

    from cxxnet_tpu_torch.artifact import bundle as ab
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.monitor.schema import validate_records
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.retrieval import EmbeddingIndex, oracle_topk
    from cxxnet_tpu_torch.serve import BinaryClient, FleetServer
    from cxxnet_tpu_torch.utils.config import parse_config

    sink.clear()
    n_clients = max(int(t) for t in args.clients.split(",") if t)
    with tempfile.TemporaryDirectory() as td:
        pimg, plab = _write_soak_idx(td, n=120, d=8, name="ix")
        model_dir = os.path.join(td, "models")
        os.makedirs(model_dir)
        conf = os.path.join(td, "run.conf")
        with open(conf, "w") as f:
            f.write('data = train\niter = mnist\n'
                    '  path_img = "%s"\n  path_label = "%s"\n'
                    '  silent = 1\niter = end\n%s\nmodel_dir = "%s"\n'
                    'print_step = 0\n'
                    % (pimg, plab, EMBED_NET, model_dir))
        snap = os.path.join(model_dir, "0001.model.npz")
        t = NetTrainer(parse_config(EMBED_NET), device=_device(args))
        t.init_model()
        t.save_model(snap)
        rc = LearnTask().run([conf, "task=build_index",
                              "model_in=%s" % snap,
                              "index_metric=cosine", "index_rows=96",
                              "search_k=8", "search_buckets=1,4,16",
                              "dev=%s" % args.dev])
        assert rc == 0, "task=build_index failed"
        bundle = ab.default_bundle_path(snap)
        idx = EmbeddingIndex.deserialize(ab.read_index_member(bundle))
        k = int(ab.bundle_manifest(bundle)["index"]["k"])
        sink.clear()        # the bench stream starts at the boot
        nvcc = kernels.nvcc_runs

        fleet = FleetServer(parse_config(EMBED_NET) + [
            ("serve_models", "bench=%s" % bundle),
            ("serve_http_port", "-1"),
            ("serve_binary_port", "0"),
            ("serve_max_delay_ms", str(args.max_delay_ms)),
            ("silent", "1"),
            ("dev", args.dev),
        ], monitor=monitor)
        fleet.start()
        try:
            rng = np.random.RandomState(0)
            pool = rng.rand(64, 64).astype(np.float32)
            # one embed pass seeds the search-only query pool and the
            # oracle spot-check (post-warmup: already zero-compile)
            bc = BinaryClient("127.0.0.1", fleet.binary_port)
            parts = []
            for i in range(0, len(pool), 16):   # <= max_batch rows
                st, part = bc.predict(pool[i:i + 16],
                                      model="bench#embed",
                                      tenant="bench")
                assert st == "ok", part
                parts.append(np.asarray(part, np.float32))
            bc.close()
            qpool = np.concatenate(parts, axis=0)

            def drive(model, rows_pool):
                lats = []
                counts = {"ok": 0, "failed": 0}
                lock = threading.Lock()
                span = max(1, len(rows_pool) - args.request_rows + 1)

                def client(ci):
                    c = BinaryClient("127.0.0.1", fleet.binary_port,
                                     timeout=120)
                    r = np.random.RandomState(ci)
                    try:
                        for _ in range(args.requests):
                            i = r.randint(0, span)
                            rows = rows_pool[i:i + args.request_rows]
                            t0 = time.monotonic()
                            st, _ = c.predict(rows, model=model,
                                              tenant="bench")
                            dt = (time.monotonic() - t0) * 1e3
                            with lock:
                                lats.append(dt)
                                counts["ok" if st == "ok"
                                       else "failed"] += 1
                    finally:
                        c.close()

                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(n_clients)]
                wall0 = time.monotonic()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                wall = time.monotonic() - wall0
                lats.sort()

                def pct(q):
                    return lats[min(len(lats) - 1,
                                    int(q * len(lats)))] \
                        if lats else 0.0

                return {
                    "model": model, "clients": n_clients,
                    "ok": counts["ok"], "failed": counts["failed"],
                    "rows_per_sec": round(
                        counts["ok"] * args.request_rows
                        / max(wall, 1e-9), 1),
                    "latency_p50_ms": round(pct(0.50), 3),
                    "latency_p99_ms": round(pct(0.99), 3),
                }

            points = []
            for name, model, rows_pool in (
                    ("embed_only", "bench#embed", pool),
                    ("search_only", "bench#search:%d" % k, qpool),
                    ("fanned_mix", "bench#fsearch:%d" % k, pool)):
                pt = drive(model, rows_pool)
                pt["scenario"] = name
                points.append(pt)
                print("# %s: %.1f rows/s, p50 %.2f ms, p99 %.2f ms, "
                      "%d ok / %d failed"
                      % (name, pt["rows_per_sec"],
                         pt["latency_p50_ms"], pt["latency_p99_ms"],
                         pt["ok"], pt["failed"]), file=sys.stderr)

            # recall spot-check: served ids vs the NumPy oracle over
            # the sealed index — exact search, so anything below 1.0
            # is a wrong answer, not an approximation
            bc = BinaryClient("127.0.0.1", fleet.binary_port)
            st, out = bc.predict(qpool[:16],
                                 model="bench#search:%d" % k,
                                 tenant="bench")
            bc.close()
            assert st == "ok", out
            got = np.asarray(out)[:, :k].astype(np.int64)
            oids, _ = oracle_topk(idx, qpool[:16], k)
            recall = float((got == oids).mean())

            health = fleet.health_snapshot()["model_health"][0]
            compiles = health["compile_events"] \
                + health.get("search_compile_events", 0) \
                + len(_compile_records(sink.records)) \
                + kernels.nvcc_runs - nvcc
            errs = validate_records(list(sink.records))
        finally:
            fleet.close()
    clean = all(p["failed"] == 0 for p in points) \
        and recall >= 0.999 and not errs
    rec = {
        "name": "serve_bench", "scenario": "embed_search",
        "t": time.time(),
        "requests_per_client": args.requests,
        "request_rows": args.request_rows,
        "index_rows": idx.rows, "dim": idx.dim,
        "metric": idx.metric, "k": k,
        "recall_at_k": round(recall, 4),
        "scenarios": points,
        "failed": sum(p["failed"] for p in points),
        "schema_errors": len(errs),
        "zero_recompiles": compiles == 0,
    }
    print("# embed-search: recall@%d %.3f vs oracle, %d failed, "
          "compiles %d" % (k, recall, rec["failed"], compiles),
          file=sys.stderr)
    return rec, clean, compiles == 0


# -- multi-replica fleet scenario (--replicas) ----------------------------


def _get_json(port, path):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return json.loads(resp.read())
    finally:
        conn.close()


def _seal_bench_bundle(cfg, snapshot, monitor, device=None):
    """Seal the bench model into a bundle so every replica boots with
    zero-compile cold start — the mechanism that makes scale-out
    cheap (doc/artifacts.md), exercised instead of assumed."""
    from cxxnet_tpu_torch.artifact.bundle import (default_bundle_path,
                                                  export_bundle)
    from cxxnet_tpu_torch.serve import ServeConfig, build_engine
    sc = ServeConfig(cfg)
    engine = build_engine(cfg, snapshot, buckets=sc.buckets,
                          max_batch=sc.max_batch, node=sc.node,
                          device=device, monitor=monitor)
    # a warm run learns the kernel libraries the bundle seals (an export
    # on the CPU seals none)
    engine.warmup()
    out = default_bundle_path(snapshot)
    export_bundle(engine, out, node=sc.node, monitor=monitor)
    return out


def _client_proc_main(ports, pool, n_clients, requests, request_rows,
                      base_ci, outq):
    """One driver WORKER PROCESS: n_clients closed-loop threads
    against the balancer tier (client ``ci`` pins to door
    ``ports[ci % len(ports)]`` — round-robin over a sharded front
    tier, the single port in a one-door fleet). Living in its own
    process keeps the client threads' GIL pressure out of the balancer
    process — in production clients are not the balancer's threads,
    and measuring them there charges their scheduling to the
    balancer's p99."""
    import threading

    from cxxnet_tpu_torch.serve import BinaryClient

    counts = {"ok": 0, "shed": 0, "failed": [], "lat": []}
    lock = threading.Lock()

    def client(ci):
        lats = []
        try:
            bc = BinaryClient("127.0.0.1", ports[ci % len(ports)],
                              timeout=120)
        except OSError as e:
            with lock:
                counts["failed"].append(repr(e))
            return
        try:
            for r in range(requests):
                start = (ci * requests + r) * request_rows % 256
                rows = np.take(pool,
                               range(start, start + request_rows),
                               axis=0, mode="wrap")
                t0 = time.time()
                try:
                    status, _ = bc.predict(rows)
                except Exception as e:
                    with lock:
                        counts["failed"].append(repr(e))
                    break
                lats.append(time.time() - t0)
                with lock:
                    if status == "ok":
                        counts["ok"] += 1
                    elif status in ("busy", "over_quota"):
                        counts["shed"] += 1
                    else:
                        counts["failed"].append(status)
        finally:
            bc.close()
            with lock:
                counts["lat"].extend(lats)

    threads = [threading.Thread(target=client, args=(base_ci + i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outq.put(counts)


def _drive_fleet(ctl, pool, clients, requests, request_rows,
                 mid_traffic=None, procs=4, ports=None):
    """Closed-loop binary clients against the balancer, spread over
    a few driver WORKER PROCESSES (the clients' own thread scheduling
    must not ride the balancer process); returns per-outcome counts
    including client-side latencies. ``mid_traffic`` (optional
    callable) runs on the driver thread once traffic is established —
    the kill injector. Sheds (busy/over_quota) are back-off signals,
    not failures; anything else non-ok is a failed request. ``ports``
    overrides the target endpoints (the sharded front tier's door
    list); default is the controller's in-process balancer."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    if ports is None:
        ports = [ctl.balancer.binary_port]
    procs = max(1, min(procs, clients))
    outq = ctx.Queue()
    share = [clients // procs + (1 if i < clients % procs else 0)
             for i in range(procs)]
    workers = []
    base = 0
    t0 = time.time()
    for i, n in enumerate(share):
        if not n:
            continue
        p = ctx.Process(target=_client_proc_main,
                        args=(list(ports), pool, n,
                              requests, request_rows, base, outq))
        p.start()
        workers.append(p)
        base += n
    if mid_traffic is not None:
        mid_traffic()
    counts = {"ok": 0, "shed": 0, "failed": [], "lat": []}
    for _ in workers:
        c = outq.get(timeout=600)
        counts["ok"] += c["ok"]
        counts["shed"] += c["shed"]
        counts["failed"].extend(c["failed"])
        counts["lat"].extend(c["lat"])
    for p in workers:
        p.join(timeout=60)
    counts["wall_s"] = time.time() - t0
    return counts


def _fleet_point_stats(sink, counts, request_rows):
    """One sweep-point row read back from the fleet_route records."""
    lat = sorted(r["latency_ms"] for r in sink.records
                 if r["event"] == "fleet_route"
                 and r["status"] == "ok")

    def pct(q):
        return round(lat[min(len(lat) - 1, int(q * len(lat)))], 3) \
            if lat else 0.0

    retries = sum(r["retries"] for r in sink.records
                  if r["event"] == "fleet_route")
    # coalesce fill: mean client requests per forwarded super-batch
    # (fleet_batch records exist only when fleet_coalesce_ms > 0)
    merged = [r for r in sink.records if r["event"] == "fleet_batch"]
    fill = round(sum(r["requests"] for r in merged)
                 / len(merged), 2) if merged else 1.0
    # CLIENT-side latency: what a caller actually waits, including
    # the socket/thread queueing BEFORE the balancer's handle() —
    # fleet_route latency starts inside handle(), so a data path
    # whose queueing happens in the coalescer (measured) would read
    # unfairly worse than one whose queueing hides in the accept/
    # scheduling path (unmeasured). The closed-loop sanity bound is
    # Little's law: mean latency = clients / throughput.
    clat = sorted(counts.get("lat", []))

    def cpct(q):
        return round(clat[min(len(clat) - 1,
                              int(q * len(clat)))] * 1e3, 3) \
            if clat else 0.0

    return {
        "client_p50_ms": cpct(0.50), "client_p99_ms": cpct(0.99),
        "requests_ok": counts["ok"], "requests_shed": counts["shed"],
        "requests_failed": len(counts["failed"]),
        "rows_per_sec": round(
            counts["ok"] * request_rows / counts["wall_s"], 2)
        if counts["wall_s"] > 0 else 0.0,
        "latency_p50_ms": pct(0.50), "latency_p99_ms": pct(0.99),
        "retries_recovered": retries,
        "coalesce_fill": fill,
        "coalesced_forwards": len(merged),
        "wall_s": round(counts["wall_s"], 2),
    }


def _fleet_fill_stats(ctl):
    """Replica-side batch economics summed over every live replica's
    /healthz model rows (cumulative batcher counters): the pad
    fraction the coalescer exists to shrink."""
    batches = batch_rows = bucket_rows = pad_rows = cap = 0
    for rep in ctl.manager.replicas():
        if not rep.alive():
            continue
        try:
            h = _get_json(rep.http_port, "/healthz")
        except (OSError, ValueError):
            continue
        for m in h.get("model_health", []):
            if "batch_rows" not in m:
                return {}          # pre-upgrade replica build
            batches += m["batches"]
            batch_rows += m["batch_rows"]
            bucket_rows += m["bucket_rows"]
            pad_rows += m["pad_rows"]
            cap += m["batches"] * m["max_batch"]
    if not batches:
        return {}
    return {
        "replica_batches": batches,
        "fill_rate": round(batch_rows / float(max(1, cap)), 4),
        "pad_fraction": round(pad_rows / float(max(1, bucket_rows)),
                              4),
    }


def _fleet_compile_events(ctl):
    """Post-warmup compile events summed over every live replica's
    /healthz — the fleet-wide zero-recompile gate."""
    total = 0
    for rep in ctl.manager.replicas():
        if not rep.alive():
            continue
        try:
            h = _get_json(rep.http_port, "/healthz")
        except (OSError, ValueError):
            continue   # died/retired between listing and probing
        total += sum(m["compile_events"]
                     for m in h.get("model_health", []))
    return total


def run_datapath_micro(ctl, pool, requests=250, clients=24):
    """Isolate the balancer→replica data path (CXN2 channels and the
    coalescer): drive ONE live replica process through each forwarding
    mode at the same offered load and count rows/s + per-wire-op
    latency. The end-to-end sweep can hide this tier behind the
    balancer process's own per-request CPU on a contended host; this
    section measures the forwarding contract itself.

    - ``v1_blocking`` — the legacy path: one blocking round trip per
      in-flight request over pooled connections (a thread per
      request).
    - ``v2_pipelined`` — the same offered concurrency multiplexed
      over two ReplicaChannels (correlated frames, out-of-order
      replies).
    - ``v2_coalesced`` — the same rows as merged super-batches (the
      balancer coalescer's forward shape, 12 rows per frame).
    """
    import threading

    from cxxnet_tpu_torch.fleet import ReplicaChannel
    from cxxnet_tpu_torch.serve import BinaryClient

    rep = ctl.manager.replicas()[0]
    rows1 = np.ascontiguousarray(pool[:1], dtype="<f4")

    def stats(lats, nrows, wall):
        lats.sort()

        def pct(q):
            return round(lats[min(len(lats) - 1,
                                  int(q * len(lats)))] * 1e3, 3) \
                if lats else 0.0

        return {"rows_per_sec": round(nrows / wall, 2),
                "wire_p50_ms": pct(0.50), "wire_p99_ms": pct(0.99)}

    def drive(fn, nthreads):
        lats = []
        lock = threading.Lock()

        def worker(ci):
            mine = []
            fn(ci, mine)
            with lock:
                lats.extend(mine)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(nthreads)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return lats, time.time() - t0

    out = {}
    # v1: blocking round trips, one connection per concurrent request
    def v1_client(ci, mine):
        bc = BinaryClient("127.0.0.1", rep.binary_port, timeout=120)
        try:
            for _ in range(requests):
                t0 = time.time()
                status, _ = bc.predict(rows1)
                assert status == "ok", status
                mine.append(time.time() - t0)
        finally:
            bc.close()

    lats, wall = drive(v1_client, clients)
    out["v1_blocking"] = dict(stats(lats, clients * requests, wall),
                              connections=clients, merge=1)

    # v2: the same offered concurrency pipelined over two channels
    chans = [ReplicaChannel("127.0.0.1", rep.binary_port, index=i)
             for i in range(2)]

    def v2_client(ci, mine):
        buf = [memoryview(rows1).cast("B")]
        for r in range(requests):
            ch = chans[(ci + r) % len(chans)]
            t0 = time.time()
            fut = ch.submit("", "", buf, 1, rows1.size, 0.0, 120.0)
            status, _ = fut.result(120)
            assert status == "ok", status
            mine.append(time.time() - t0)

    lats, wall = drive(v2_client, clients)
    out["v2_pipelined"] = dict(stats(lats, clients * requests, wall),
                               connections=len(chans), merge=1)

    # v2 coalesced: the same rows as 12-row super-batches
    merge = 12
    groups = max(1, clients // merge)
    big = np.ascontiguousarray(
        np.repeat(rows1, merge, axis=0), dtype="<f4")

    def v2_merged(ci, mine):
        buf = [memoryview(big).cast("B")]
        for r in range(requests):
            ch = chans[(ci + r) % len(chans)]
            t0 = time.time()
            fut = ch.submit("", "", buf, merge, rows1.size, 0.0,
                            120.0)
            status, _ = fut.result(120)
            assert status == "ok", status
            mine.append(time.time() - t0)

    lats, wall = drive(v2_merged, groups)
    out["v2_coalesced"] = dict(
        stats(lats, groups * requests * merge, wall),
        connections=len(chans), merge=merge)
    for ch in chans:
        ch.close()
    return out


def run_multi_replica(args, monitor, sink):
    """``--replicas N1,N2,...``: rows/s + p99 at each fleet size,
    then (at the largest size) the kill-a-replica scenario — SIGKILL
    one replica process mid-traffic, assert ZERO failed requests —
    and, with ``--autoscale-soak S``, an elasticity soak: drive load
    until the controller scales out, go idle until it drains back,
    zero dropped requests throughout."""
    import os
    import signal
    import tempfile

    from cxxnet_tpu_torch.fleet import FleetController
    from cxxnet_tpu_torch.monitor.schema import validate_records
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config, parse_config_file

    rng = np.random.RandomState(0)
    sizes = [int(t) for t in args.replicas.split(",") if t]
    record = {"name": "serve_bench", "mode": "multi_replica",
              "t": time.time(),
              "requests_per_client": args.requests,
              "request_rows": args.request_rows,
              "buckets": args.buckets,
              "max_delay_ms": args.max_delay_ms,
              "dtype": args.serve_dtype or "float32",
              "coalesce_ms": args.coalesce_ms,
              "channels_per_replica": args.channels,
              "slo_p99_ms": args.slo_p99_ms}
    failures, recompiles = 0, 0
    # the CLI serve knobs must reach the REPLICA processes (which read
    # conf_path + these overrides), or the record would label a sweep
    # that never ran with them
    serve_overrides = [
        "serve_buckets=%s" % args.buckets,
        "serve_max_delay_ms=%g" % args.max_delay_ms,
        "serve_queue_rows=%d" % (args.queue_rows or 4096),
        "dev=%s" % args.dev,
    ]
    if args.serve_dtype:
        serve_overrides.append("serve_dtype=%s" % args.serve_dtype)
    with tempfile.TemporaryDirectory() as td:
        if args.conf:
            assert args.model_in, "--conf needs --model-in"
            conf_path = args.conf
            cfg = parse_config_file(args.conf) + [
                (p.split("=", 1)[0], p.split("=", 1)[1])
                for p in serve_overrides]
            source = args.artifact or args.model_in
        else:
            conf_text = SYNTH_CONF + (
                "\nserve_buckets = %s\nserve_max_delay_ms = %g\n"
                "serve_queue_rows = %d\n"
                % (args.buckets, args.max_delay_ms,
                   args.queue_rows or 4096))
            if args.serve_dtype:
                conf_text += "serve_dtype = %s\n" % args.serve_dtype
            conf_path = os.path.join(td, "bench.conf")
            with open(conf_path, "w") as f:
                f.write(conf_text)
            cfg = parse_config(conf_text)
            trainer = NetTrainer(cfg, device=_device(args))
            trainer.init_model()
            snap = os.path.join(td, "0001.model.npz")
            trainer.save_model(snap)
            # replicas boot from the sealed bundle: zero-compile cold
            # start is the whole reason scale-out is cheap
            source = args.artifact or _seal_bench_bundle(
                cfg, snap, monitor, device=_device(args))
        record["model"] = os.path.basename(source)
        pool = None
        tier_base = [
            ("model_in", source),
            ("fleet_http_port", "0"), ("fleet_binary_port", "0"),
            ("fleet_health_poll_s", "0.2"),
            ("fleet_dir", os.path.join(td, "run")),
        ]

        # the data path under test (channels + coalescing); the
        # baseline sweep pins the legacy path (pooled, no coalescing)
        datapath = [
            ("fleet_channels_per_replica", str(args.channels)),
            ("fleet_coalesce_ms", "%g" % args.coalesce_ms),
        ]
        baseline_path = [
            ("fleet_channels_per_replica", "0"),
            ("fleet_coalesce_ms", "0"),
        ]

        def boot(n, extra=(), path=None):
            ctl = FleetController(
                cfg + tier_base + [("fleet_replicas", str(n)),
                                   ("fleet_min_replicas", str(n))]
                + (datapath if path is None else list(path))
                + list(extra),
                conf_path=conf_path, monitor=monitor,
                extra_overrides=serve_overrides)
            ctl.start()
            return ctl

        def one_point(n, path=None):
            nonlocal pool, recompiles
            sink.clear()
            t0 = time.time()
            ctl = boot(n, path=path)
            boot_s = time.time() - t0
            if pool is None:
                inst = tuple(_get_json(
                    ctl.manager.replicas()[0].http_port,
                    "/v1/models")["models"][0]["instance_shape"])
                pool = rng.uniform(0, 1, size=(256,) + inst) \
                    .astype(np.float32)
            cpr = args.fleet_clients_per_replica
            counts = _drive_fleet(ctl, pool, clients=cpr * n,
                                  requests=args.requests,
                                  request_rows=args.request_rows)
            recompiles += _fleet_compile_events(ctl)
            fill = _fleet_fill_stats(ctl)
            ctl.close()
            errs = validate_records(sink.records)
            assert not errs, "schema-invalid fleet telemetry: %s" \
                % errs[:5]
            return dict(_fleet_point_stats(sink, counts,
                                           args.request_rows),
                        replicas=n, clients=cpr * n,
                        boot_s=round(boot_s, 2), **fill)

        sweep = []
        for n in sizes:
            pt = one_point(n)
            failures += pt["requests_failed"]
            sweep.append(pt)
            print("# replicas=%d: %.1f rows/s, client p50 %.2f ms "
                  "p99 %.2f ms, %d ok / %d failed, coalesce fill "
                  "%.2f, pad %.3f"
                  % (n, pt["rows_per_sec"], pt["client_p50_ms"],
                     pt["client_p99_ms"], pt["requests_ok"],
                     pt["requests_failed"], pt["coalesce_fill"],
                     pt.get("pad_fraction", -1)), file=sys.stderr)
        record["sweep"] = sweep

        if args.fleet_baseline:
            # before/after on the same model and drive: the legacy data
            # path (pooled connections, no coalescing) per fleet size
            base = []
            for n in sizes:
                pt = one_point(n, path=baseline_path)
                failures += pt["requests_failed"]
                base.append(pt)
                print("# baseline replicas=%d: %.1f rows/s, client "
                      "p50 %.2f ms p99 %.2f ms, pad %.3f"
                      % (n, pt["rows_per_sec"], pt["client_p50_ms"],
                         pt["client_p99_ms"],
                         pt.get("pad_fraction", -1)),
                      file=sys.stderr)
            record["sweep_baseline"] = base

        # -- data-path micro: the balancer→replica tier isolated -----
        ctl = boot(1)
        record["datapath_micro"] = run_datapath_micro(
            ctl, pool, requests=min(args.requests, 250))
        ctl.close()
        for mode, m in record["datapath_micro"].items():
            print("# datapath %-13s %8.1f rows/s, wire p50 %.2f ms "
                  "p99 %.2f ms (merge=%d over %d conns)"
                  % (mode, m["rows_per_sec"], m["wire_p50_ms"],
                     m["wire_p99_ms"], m["merge"], m["connections"]),
                  file=sys.stderr)

        # -- kill-a-replica mid-traffic (at the largest fleet) -------
        sink.clear()
        n = max(sizes)
        ctl = boot(n, extra=[("fleet_scale_interval_s", "0.2")])

        def killer():
            time.sleep(0.3)           # let traffic establish
            victim = ctl.manager.replicas()[0]
            os.kill(victim.pid, signal.SIGKILL)
            print("# killed replica %s (pid %d) mid-traffic"
                  % (victim.replica_id, victim.pid), file=sys.stderr)

        counts = _drive_fleet(
            ctl, pool, clients=args.fleet_clients_per_replica * n,
            requests=args.requests, request_rows=args.request_rows,
            mid_traffic=killer)
        healed = sum(1 for r in ctl.manager.replicas()
                     if r.alive()) >= n
        recompiles += _fleet_compile_events(ctl)
        ctl.close()
        kill_pt = _fleet_point_stats(sink, counts, args.request_rows)
        kill_pt.update({
            "replicas": n, "replica_killed": True,
            "self_healed": healed,
            "replica_lost_events": sum(
                1 for r in sink.records
                if r["event"] == "fleet_scale"
                and r["action"] == "replica_lost"),
        })
        failures += kill_pt["requests_failed"]
        record["kill_replica"] = kill_pt
        print("# kill-a-replica: %d ok / %d failed, %d retries "
              "recovered, self_healed=%s"
              % (kill_pt["requests_ok"], kill_pt["requests_failed"],
                 kill_pt["retries_recovered"], healed),
              file=sys.stderr)

        # -- autoscale soak ------------------------------------------
        if args.autoscale_soak > 0:
            sink.clear()
            ctl = boot(1, extra=[
                ("fleet_min_replicas", "1"),
                ("fleet_max_replicas", str(max(2, max(sizes)))),
                ("fleet_scale_interval_s", "0.3"),
                ("fleet_scale_up_after_s", "0.6"),
                ("fleet_scale_down_after_s", "1.5"),
            ])
            import threading
            stop = threading.Event()
            soak = {"ok": 0, "shed": 0, "failed": []}
            lock = threading.Lock()

            def hammer(ci):
                from cxxnet_tpu_torch.serve import BinaryClient
                bc = BinaryClient("127.0.0.1",
                                  ctl.balancer.binary_port,
                                  timeout=120)
                try:
                    while not stop.is_set():
                        rows = pool[(ci * 7) % 128:
                                    (ci * 7) % 128 + 8]
                        try:
                            status, _ = bc.predict(rows)
                        except Exception as e:
                            with lock:
                                soak["failed"].append(repr(e))
                            return
                        with lock:
                            if status == "ok":
                                soak["ok"] += 1
                            elif status in ("busy", "over_quota"):
                                soak["shed"] += 1
                            else:
                                soak["failed"].append(status)
                finally:
                    bc.close()

            threads = [threading.Thread(target=hammer, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            deadline = time.time() + args.autoscale_soak

            def saw(action):
                return any(r["event"] == "fleet_scale"
                           and r["action"] == action
                           for r in sink.records)

            while time.time() < deadline and not saw("scale_out"):
                time.sleep(0.2)
            scaled_out = saw("scale_out")
            stop.set()
            for t in threads:
                t.join()
            deadline = time.time() + args.autoscale_soak
            while time.time() < deadline and not saw("scale_in"):
                time.sleep(0.2)
            recompiles += _fleet_compile_events(ctl)
            ctl.close()
            record["autoscale"] = {
                "scaled_out": scaled_out, "scaled_in": saw("scale_in"),
                "requests_ok": soak["ok"],
                "requests_shed": soak["shed"],
                "requests_failed": len(soak["failed"]),
                "max_ready_seen": max(
                    (r["ready"] for r in sink.records
                     if r["event"] == "fleet_scale"), default=1),
            }
            failures += len(soak["failed"])
            if not (scaled_out and record["autoscale"]["scaled_in"]):
                failures += 1          # the soak's own assertion
            print("# autoscale soak: out=%s in=%s, %d ok / %d shed "
                  "/ %d failed"
                  % (scaled_out, record["autoscale"]["scaled_in"],
                     soak["ok"], soak["shed"],
                     len(soak["failed"])), file=sys.stderr)
    slo_ok = all(p["latency_p99_ms"] <= args.slo_p99_ms
                 for p in sweep) if args.slo_p99_ms else True
    record["slo_ok"] = slo_ok
    record["zero_recompiles"] = recompiles == 0
    record["zero_failed_requests"] = failures == 0
    return record, failures == 0 and slo_ok, recompiles == 0


# -- sharded front tier scenario (--balancers) -----------------------------


def _null_replica_main(port_file):
    """A no-engine fleet replica for FRONT-TIER isolation: answers
    both binary protocol versions instantly (ok, one float per row)
    and ``/healthz`` with a healthy body. Driving N doors over null
    replicas measures the balancer tier itself — frame parse, quota
    admit, route, forward — with model dispatch taken out of the
    denominator (the ``run_datapath_micro`` methodology applied one
    tier up)."""
    import socket
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from cxxnet_tpu_torch.fleet.placement import write_endpoint_file
    from cxxnet_tpu_torch.serve.frontend import (BIN_MAGIC_V2, STATUS_OK,
                                                 _REQ_HEADER,
                                                 _REQ_HEADER_V2,
                                                 _read_exact, pack_reply,
                                                 pack_reply_v2)

    class _Health(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"ok": 1, "queue_rows": 0,
                               "model_health": []}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # no access log
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Health)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(128)

    def serve_conn(sock):
        rfile = sock.makefile("rb")
        try:
            while True:
                magic = _read_exact(rfile, 4)
                if magic is None or len(magic) < 4:
                    return
                if magic == BIN_MAGIC_V2:
                    rest = _read_exact(rfile, _REQ_HEADER_V2.size - 4)
                    if rest is None \
                            or len(rest) < _REQ_HEADER_V2.size - 4:
                        return
                    (_, corr, ml, tl, nrows, elems,
                     _t) = _REQ_HEADER_V2.unpack(magic + rest)
                else:
                    rest = _read_exact(rfile, _REQ_HEADER.size - 4)
                    if rest is None \
                            or len(rest) < _REQ_HEADER.size - 4:
                        return
                    (_, ml, tl, nrows, elems,
                     _t) = _REQ_HEADER.unpack(magic + rest)
                    corr = None
                if ml + tl:
                    _read_exact(rfile, ml + tl)
                if nrows * elems:
                    _read_exact(rfile, nrows * elems * 4)
                if corr is None:
                    sock.sendall(pack_reply(
                        STATUS_OK, np.zeros((nrows, 1), "<f4")))
                elif nrows == 0:
                    sock.sendall(pack_reply_v2(corr, STATUS_OK))
                else:
                    sock.sendall(pack_reply_v2(
                        corr, STATUS_OK, np.zeros((nrows, 1), "<f4")))
        except (OSError, ValueError):
            return   # client went away / torn frame: drop the conn
        finally:
            try:
                sock.close()
            except OSError:
                pass  # cxxlint: disable=CXL006 -- teardown of a dead client socket; nothing to do with a close error

    def accept_loop():
        while True:
            conn, _ = lsock.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=serve_conn, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    write_endpoint_file(port_file, {
        "pid": os.getpid(),
        "http_port": httpd.server_address[1],
        "binary_port": lsock.getsockname()[1]})
    while True:
        time.sleep(3600)


def _spawn_null_replicas(ctx, td, n):
    """Fork ``n`` null replicas; returns [(proc, ports_dict)]."""
    import os
    nulls = []
    for i in range(n):
        pf = os.path.join(td, "null%d.ports.json" % i)
        p = ctx.Process(target=_null_replica_main, args=(pf,),
                        daemon=True)
        p.start()
        deadline = time.time() + 30
        while not os.path.exists(pf):
            assert p.is_alive(), "null replica %d died booting" % i
            assert time.time() < deadline, \
                "null replica %d: no port file" % i
            time.sleep(0.02)
        with open(pf) as f:
            nulls.append((p, json.load(f)))
    return nulls


def _boot_front_tier(td, tag, n, nulls, extra_conf="",
                     monitor_dir="", extra_overrides=()):
    """Boot ``n`` real ``task=fleet_balancer`` door processes over the
    null replicas: the bench stands in for the controller — it writes
    the endpoint registry (replicas first, then each door as it
    publishes ports) and the doors reconcile from it. Returns
    (manager, registry, doors) with every door reporting all replicas
    ready and the full peer set."""
    import os

    from cxxnet_tpu_torch.fleet import FleetTierConfig
    from cxxnet_tpu_torch.fleet.placement import (BalancerManager,
                                                  EndpointRegistry,
                                                  endpoint_entry)
    from cxxnet_tpu_torch.utils.config import parse_config

    fleet_dir = os.path.join(td, "front_%s" % tag)
    conf_text = ("fleet_source = null-model\n"
                 "fleet_balancers = %d\n"
                 "fleet_dir = %s\n"
                 "fleet_gossip_s = 0.2\n"
                 "fleet_health_poll_s = 0.2\n" % (n, fleet_dir)) \
        + extra_conf
    conf_path = os.path.join(td, "front_%s.conf" % tag)
    with open(conf_path, "w") as f:
        f.write(conf_text)
    tier = FleetTierConfig(parse_config(conf_text))
    registry = EndpointRegistry(tier.registry_path)
    registry.write([
        endpoint_entry("r%03d" % (i + 1), "replica", "127.0.0.1",
                       ports["http_port"], ports["binary_port"],
                       version="null", pid=ports["pid"])
        for i, (_p, ports) in enumerate(nulls)])
    mgr = BalancerManager(conf_path, tier, monitor_dir=monitor_dir,
                          extra_overrides=extra_overrides)
    doors = []
    try:
        for i in range(n):
            door = mgr.spawn(i)
            registry.upsert(endpoint_entry(
                door.balancer_id, "balancer", door.host,
                door.http_port, door.binary_port, pid=door.pid))
            doors.append(door)
        # doors sync the registry on a 0.2 s cadence: wait until every
        # door has polled all replicas healthy and knows its peers
        deadline = time.time() + 30
        for door in doors:
            while True:
                try:
                    h = _get_json(door.http_port, "/healthz")
                    if h.get("ready", 0) >= len(nulls) \
                            and h.get("balancers", 0) >= n:
                        break
                except (OSError, ValueError):
                    pass  # cxxlint: disable=CXL006 -- door still binding its listener; the deadline below is the real guard
                assert time.time() < deadline, \
                    "door %s never became ready" % door.balancer_id
                time.sleep(0.05)
    except BaseException:
        mgr.close()
        raise
    return mgr, registry, doors


def _front_point_stats(counts, request_rows):
    """One front-tier drive summarized from CLIENT-side counts (the
    doors are separate processes; their telemetry is captured
    separately via per-door monitor files)."""
    clat = sorted(counts.get("lat", []))

    def cpct(q):
        return round(clat[min(len(clat) - 1,
                              int(q * len(clat)))] * 1e3, 3) \
            if clat else 0.0

    return {
        "client_p50_ms": cpct(0.50), "client_p99_ms": cpct(0.99),
        "requests_ok": counts["ok"], "requests_shed": counts["shed"],
        "requests_failed": len(counts["failed"]),
        "rows_per_sec": round(
            counts["ok"] * request_rows / counts["wall_s"], 2)
        if counts["wall_s"] > 0 else 0.0,
        "wall_s": round(counts["wall_s"], 2),
    }


def _failover_proc_main(bin_eps, http_eps, pool, n_clients, requests,
                        request_rows, base_ci, outq):
    """One kill-scenario WORKER PROCESS: even clients drive the binary
    protocol, odd clients HTTP/JSON, all through the failover clients
    holding the FULL door list — a SIGKILLed door must cost a silent
    reconnect, never a failed request."""
    import threading

    from cxxnet_tpu_torch.serve import FailoverBinaryClient, FailoverHttpClient

    counts = {"ok": 0, "shed": 0, "failed": [], "lat": [],
              "failovers": 0}
    lock = threading.Lock()

    def client(ci):
        lats = []
        http_mode = ci % 2 == 1
        # rotate the endpoint list per client so load starts spread
        # over every door — including the one about to be killed
        off = (ci // 2) % len(bin_eps)
        eps = (http_eps if http_mode else bin_eps)
        eps = eps[off:] + eps[:off]
        fc = FailoverHttpClient(eps, timeout=120) if http_mode \
            else FailoverBinaryClient(eps, timeout=120)
        try:
            for r in range(requests):
                start = (ci * requests + r) * request_rows % 256
                rows = np.take(pool,
                               range(start, start + request_rows),
                               axis=0, mode="wrap")
                t0 = time.time()
                try:
                    if http_mode:
                        code, _body = fc.predict("", "", rows)
                        status = "ok" if code == 200 else (
                            "shed" if code == 429 else "failed:%d"
                            % code)
                    else:
                        status, _ = fc.predict(rows)
                except Exception as e:
                    with lock:
                        counts["failed"].append(repr(e))
                    break
                lats.append(time.time() - t0)
                with lock:
                    if status in ("ok", "busy", "over_quota", "shed"):
                        counts["ok" if status == "ok"
                               else "shed"] += 1
                    else:
                        counts["failed"].append(status)
        finally:
            fc.close()
            with lock:
                counts["lat"].extend(lats)
                counts["failovers"] += fc.failovers

    threads = [threading.Thread(target=client, args=(base_ci + i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outq.put(counts)


def _drive_failover(doors, pool, clients, requests, request_rows,
                    mid_traffic=None, procs=2):
    """The kill drive: HTTP+binary failover clients over every door,
    spread over worker processes like ``_drive_fleet``."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    bin_eps = [("127.0.0.1", d.binary_port) for d in doors]
    http_eps = [("127.0.0.1", d.http_port) for d in doors]
    procs = max(1, min(procs, clients))
    outq = ctx.Queue()
    share = [clients // procs + (1 if i < clients % procs else 0)
             for i in range(procs)]
    workers = []
    base = 0
    t0 = time.time()
    for n in share:
        if not n:
            continue
        p = ctx.Process(target=_failover_proc_main,
                        args=(bin_eps, http_eps, pool, n, requests,
                              request_rows, base, outq))
        p.start()
        workers.append(p)
        base += n
    if mid_traffic is not None:
        mid_traffic()
    counts = {"ok": 0, "shed": 0, "failed": [], "lat": [],
              "failovers": 0}
    for _ in workers:
        c = outq.get(timeout=600)
        for k in ("ok", "shed", "failovers"):
            counts[k] += c[k]
        counts["failed"].extend(c["failed"])
        counts["lat"].extend(c["lat"])
    for p in workers:
        p.join(timeout=60)
    counts["wall_s"] = time.time() - t0
    return counts


def _front_quota_drive(doors, pool, request_rows, duration_s):
    """Hammer tenant ``hog`` (quota'd fleet-wide) and tenant ``good``
    (unquoted) through EVERY door at once; returns per-door, per-
    tenant outcome counts plus the measured wall."""
    import threading

    from cxxnet_tpu_torch.serve import BinaryClient

    res = {t: {d.balancer_id: {"ok": 0, "shed": 0, "failed": 0}
               for d in doors} for t in ("hog", "good")}
    lock = threading.Lock()
    rows = pool[:request_rows]
    stop_at = time.time() + duration_s

    def drive(tenant, door):
        slot = res[tenant][door.balancer_id]
        try:
            bc = BinaryClient("127.0.0.1", door.binary_port,
                              timeout=60)
        except OSError:
            with lock:
                slot["failed"] += 1
            return
        try:
            while time.time() < stop_at:
                try:
                    status, _ = bc.predict(rows, tenant=tenant)
                except Exception:
                    with lock:
                        slot["failed"] += 1
                    return
                with lock:
                    if status == "ok":
                        slot["ok"] += 1
                    elif status == "over_quota":
                        slot["shed"] += 1
                    else:
                        slot["failed"] += 1
                # realistic clients back off on a shed / pace a
                # light tenant; a shed-speed spin would just burn
                # the single CPU every process here shares
                if status != "ok" or tenant == "good":
                    time.sleep(0.02 if tenant == "good" else 0.005)
        finally:
            bc.close()

    threads = [threading.Thread(target=drive, args=(t, d))
               for d in doors
               for t in ("hog", "hog", "good")]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res["wall_s"] = time.time() - t0
    return res


def _door_sheds_typed_429(door, rows):
    """POST over-quota traffic at ONE door until it answers the typed
    429 contract: status 429, JSON error=over_quota, Retry-After."""
    import http.client
    body = json.dumps({"model": "", "tenant": "hog",
                       "rows": rows.tolist()})
    for _ in range(100):
        conn = http.client.HTTPConnection("127.0.0.1", door.http_port,
                                          timeout=10)
        try:
            conn.request("POST", "/v1/predict", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read() or b"{}")
            if resp.status == 429 \
                    and payload.get("error") == "over_quota" \
                    and resp.getheader("Retry-After"):
                return True
        finally:
            conn.close()
    return False


def run_front_tier(args, monitor, sink):
    """``--balancers N1,N2,...``: the sharded front tier measured in
    isolation. Each point boots N real ``task=fleet_balancer``
    processes over engine-less null replicas and drives a FIXED total
    client count round-robin across the doors — so rows/s differences
    come from sharding the tier, not from changing offered load — with
    median-of-``--front-repeats`` and a per-point spread field. At the
    largest N: the SIGKILL-a-door scenario (concurrent HTTP+binary
    failover clients, zero failed requests) and the distributed-quota
    scenario (typed 429 through every door; fleet-wide admitted rate
    bounded by the configured rate plus one rebalance window)."""
    import multiprocessing as mp
    import os
    import signal
    import tempfile

    from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records

    sizes = [int(t) for t in args.balancers.split(",") if t]
    repeats = max(1, args.front_repeats)
    rng = np.random.RandomState(0)
    pool = rng.uniform(0, 1, size=(256, 16)).astype(np.float32)
    rate, burst = 200.0, 40.0
    rebalance_s = 0.5
    record = {
        "name": "serve_bench", "mode": "front_tier",
        "t": time.time(),
        "requests_per_client": args.requests,
        "request_rows": args.request_rows,
        "clients_total": args.front_clients,
        "null_replicas": args.front_replicas,
        "repeats": repeats,
        "isolation": "doors forward to engine-less null replicas: "
                     "the capture measures the balancer tier (frame "
                     "parse, quota admit, route, forward), not model "
                     "dispatch",
        "caveat": "single-CPU container: all doors share one core, "
                  "so scaling gains come from splitting a fixed "
                  "client load across smaller per-process thread "
                  "sets (less GIL/scheduler contention), not from "
                  "added compute; expect noisy, sub-linear points",
    }
    failures = 0
    # the doors compute nothing and resolve no device; they get the
    # flag as every process the tool starts does
    door_dev = ["dev=%s" % args.dev]
    ctx = mp.get_context("fork")
    with tempfile.TemporaryDirectory() as td:
        nulls = _spawn_null_replicas(ctx, td, args.front_replicas)
        try:
            sweep = []
            for n in sizes:
                t0 = time.time()
                mgr, _reg, doors = _boot_front_tier(
                    td, "n%d" % n, n, nulls, extra_overrides=door_dev)
                boot_s = time.time() - t0
                try:
                    runs = []
                    for _ in range(repeats):
                        counts = _drive_fleet(
                            None, pool, clients=args.front_clients,
                            requests=args.requests,
                            request_rows=args.request_rows,
                            ports=[d.binary_port for d in doors])
                        runs.append(_front_point_stats(
                            counts, args.request_rows))
                finally:
                    mgr.close()
                rates = sorted(r["rows_per_sec"] for r in runs)
                mid = runs[[r["rows_per_sec"]
                            for r in runs].index(rates[len(rates)
                                                       // 2])]
                pt = dict(mid, balancers=n,
                          boot_s=round(boot_s, 2),
                          rows_per_sec=rates[len(rates) // 2],
                          rows_per_sec_runs=rates,
                          rows_per_sec_spread=round(
                              rates[-1] - rates[0], 2))
                failures += sum(r["requests_failed"] for r in runs)
                sweep.append(pt)
                print("# balancers=%d: median %.1f rows/s (spread "
                      "%.1f over %d runs), client p50 %.2f ms p99 "
                      "%.2f ms, %d ok / %d failed"
                      % (n, pt["rows_per_sec"],
                         pt["rows_per_sec_spread"], repeats,
                         pt["client_p50_ms"], pt["client_p99_ms"],
                         pt["requests_ok"], pt["requests_failed"]),
                      file=sys.stderr)
            record["sweep"] = sweep
            med = [p["rows_per_sec"] for p in sweep]
            record["rows_per_sec_monotonic"] = all(
                b > a for a, b in zip(med, med[1:]))

            # -- distributed quota + kill-a-door at the largest N ----
            n = max(sizes)
            quota_conf = ("serve_quota = hog:%g:%g\n"
                          "fleet_quota_rebalance_s = %g\n"
                          % (rate, burst, rebalance_s))
            mdir = os.path.join(td, "door_telemetry")
            os.makedirs(mdir, exist_ok=True)
            mgr, _reg, doors = _boot_front_tier(
                td, "quota", n, nulls, extra_conf=quota_conf,
                monitor_dir=mdir, extra_overrides=door_dev)
            try:
                qrows = 4
                q = _front_quota_drive(doors, pool, qrows,
                                       duration_s=6.0)
                wall = q["wall_s"]
                admitted = sum(s["ok"] for s in q["hog"].values()) \
                    * qrows
                bound = rate * (wall + rebalance_s) + burst
                # probe rows > fleet burst: no door's share can ever
                # admit it, so the FIRST well-formed answer must be
                # the typed 429 regardless of how shares rebalanced
                typed = {d.balancer_id:
                         _door_sheds_typed_429(d, pool)
                         for d in doors}
                shares = {}
                for d in doors:
                    try:
                        h = _get_json(d.http_port, "/healthz")
                        shares[d.balancer_id] = h.get("quota_shares")
                    except (OSError, ValueError):
                        shares[d.balancer_id] = None
                quota_rec = {
                    "balancers": n, "rate": rate, "burst": burst,
                    "rebalance_s": rebalance_s, "wall_s":
                    round(wall, 2),
                    "hog": {b: dict(s) for b, s in q["hog"].items()},
                    "good": {b: dict(s)
                             for b, s in q["good"].items()},
                    "admitted_rows": admitted,
                    "admitted_rows_per_sec": round(admitted / wall, 2)
                    if wall else 0.0,
                    "bound_rows": round(bound, 1),
                    "within_bound": admitted <= bound,
                    "typed_429_every_door": all(typed.values()),
                    "typed_429_by_door": typed,
                    "quota_shares": shares,
                }
                every_door_shed = all(
                    s["shed"] > 0 for s in q["hog"].values())
                good_ok = all(s["ok"] > 0 and s["failed"] == 0
                              for s in q["good"].values())
                quota_rec["hog_shed_every_door"] = every_door_shed
                quota_rec["in_quota_clean"] = good_ok
                record["distributed_quota"] = quota_rec
                if not (quota_rec["within_bound"] and every_door_shed
                        and good_ok
                        and quota_rec["typed_429_every_door"]):
                    failures += 1
                print("# quota: admitted %.1f rows/s vs bound %.1f "
                      "(rate %g + one %gs rebalance window), 429 "
                      "through every door=%s, in-quota clean=%s"
                      % (quota_rec["admitted_rows_per_sec"],
                         bound / wall if wall else 0.0, rate,
                         rebalance_s,
                         quota_rec["typed_429_every_door"], good_ok),
                      file=sys.stderr)

                # -- SIGKILL a door under HTTP+binary load ----------
                victim = doors[-1]

                def killer():
                    time.sleep(0.25)      # let traffic establish
                    os.kill(victim.pid, signal.SIGKILL)
                    print("# killed balancer %s (pid %d) mid-traffic"
                          % (victim.balancer_id, victim.pid),
                          file=sys.stderr)

                counts = _drive_failover(
                    doors, pool, clients=args.front_clients,
                    requests=args.requests,
                    request_rows=args.request_rows,
                    mid_traffic=killer if n > 1 else None)
                kill_pt = dict(
                    _front_point_stats(counts, args.request_rows),
                    balancers=n, balancer_killed=n > 1,
                    failovers=counts["failovers"])
                failures += kill_pt["requests_failed"]
                record["kill_balancer"] = kill_pt
                print("# kill-a-balancer: %d ok / %d shed / %d "
                      "failed, %d failovers"
                      % (kill_pt["requests_ok"],
                         kill_pt["requests_shed"],
                         kill_pt["requests_failed"],
                         kill_pt["failovers"]), file=sys.stderr)
            finally:
                mgr.close()
            # the doors' own telemetry streams (monitor=jsonl per
            # door): schema-validated, and the route records must
            # carry each door's balancer id
            door_events = {"fleet_route": 0, "tenant_shed": 0,
                           "quota_rebalance": 0}
            route_doors = set()
            for fn in sorted(os.listdir(mdir)):
                recs = read_jsonl(os.path.join(mdir, fn))
                errs = validate_records(recs, strict=False)
                assert not errs, \
                    "door %s emitted schema-invalid telemetry: %s" \
                    % (fn, errs[:5])
                for r in recs:
                    if r["event"] in door_events:
                        door_events[r["event"]] += 1
                    if r["event"] == "fleet_route":
                        route_doors.add(r["balancer"])
            record["door_telemetry"] = dict(
                door_events, route_balancers=sorted(route_doors),
                streams=len(os.listdir(mdir)))
        finally:
            for p, _ports in nulls:
                p.terminate()
            for p, _ports in nulls:
                p.join(timeout=10)
    record["zero_failed_requests"] = failures == 0
    record["zero_recompiles"] = True     # nothing compiles: no engines
    return record, failures == 0, True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--clients", default="1,2,4,8",
                    help="comma list of concurrent client counts")
    ap.add_argument("--requests", type=int, default=50,
                    help="closed-loop requests per client")
    ap.add_argument("--request-rows", type=int, default=1)
    ap.add_argument("--buckets", default="auto")
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--queue-rows", type=int, default=0)
    ap.add_argument("--conf", default="",
                    help="config file (with --model-in) instead of the "
                         "synthetic MLP")
    ap.add_argument("--model-in", default="")
    ap.add_argument("--artifact", default="",
                    help="sealed artifact bundle (task=export, "
                         "doc/artifacts.md) to boot every session "
                         "from; adds a cold-start column (time-to-"
                         "first-reply, compile count) to the record — "
                         "plus the snapshot-boot baseline column when "
                         "--conf/--model-in are also given")
    ap.add_argument("--out", default="",
                    help="also write the JSON record to this path")
    ap.add_argument("--tenants", default="",
                    help="multi-tenant scenario: comma list of "
                         "name:clients[:rate[:burst]] (rate in "
                         "rows/s; 0 = unlimited)")
    ap.add_argument("--replicas", default="",
                    help="multi-replica fleet scenario: comma list "
                         "of replica-process counts (e.g. 1,2,4); "
                         "each point boots a fleet of N task="
                         "serve_fleet processes from a sealed bundle "
                         "behind the balancer, plus a kill-a-replica-"
                         "mid-traffic assertion (zero failed "
                         "requests) at the largest N")
    ap.add_argument("--generations", type=int, default=0,
                    help="continual train-while-serve soak "
                         "(doc/continual.md): run a task=continual-"
                         "style loop for N generations with closed-"
                         "loop clients hammering the fleet across "
                         "every hot-swap; exits 3 on any dropped "
                         "request or a non-improving gated eval, 1 "
                         "on post-warmup compiles (the existing "
                         "exit-code convention)")
    ap.add_argument("--fleet-clients-per-replica", type=int,
                    default=4,
                    help="with --replicas: closed-loop clients per "
                         "replica at each sweep point (default 4, "
                         "the legacy drive; raise it for the "
                         "high-concurrency small-request regime "
                         "coalescing targets)")
    ap.add_argument("--coalesce-ms", type=float, default=0.0,
                    help="with --replicas: balancer-side coalesce "
                         "window (fleet_coalesce_ms) — same-model "
                         "requests arriving within it forward as one "
                         "super-batch; 0 = off")
    ap.add_argument("--channels", type=int, default=2,
                    help="with --replicas: multiplexed v2 channels "
                         "per replica (fleet_channels_per_replica); "
                         "0 = the pooled v1 data path")
    ap.add_argument("--balancers", default="",
                    help="comma list of front-tier sizes (e.g. 1,2,4):"
                         " boot N task=fleet_balancer processes over "
                         "engine-less null replicas and measure the "
                         "sharded front tier in isolation — fixed "
                         "total client count split across the doors, "
                         "median-of---front-repeats rows/s per point, "
                         "then kill-a-door (zero failed requests) and "
                         "distributed-quota scenarios at the largest N")
    ap.add_argument("--front-clients", type=int, default=16,
                    help="TOTAL concurrent clients for --balancers "
                         "(held fixed across front-tier sizes so the "
                         "offered load is identical at every point)")
    ap.add_argument("--front-replicas", type=int, default=2,
                    help="null replicas behind the front tier for "
                         "--balancers")
    ap.add_argument("--front-repeats", type=int, default=3,
                    help="repetitions per --balancers point; the "
                         "headline rows/s is the median and the "
                         "record carries the per-point spread")
    ap.add_argument("--fleet-baseline", action="store_true",
                    help="with --replicas: also sweep the legacy "
                         "data path (pooled connections, no "
                         "coalescing) for a before/after record")
    ap.add_argument("--autoscale-soak", type=float, default=0.0,
                    help="with --replicas: also run an autoscale "
                         "soak capped at this many seconds per "
                         "phase — load until the controller scales "
                         "out, idle until it drains back in, zero "
                         "dropped requests throughout")
    ap.add_argument("--slo-p99-ms", type=float, default=0.0,
                    help="per-tenant ok-request p99 SLO; breach "
                         "exits 3 (0 = no assertion)")
    ap.add_argument("--serve-dtype", default="",
                    choices=["", "float32", "bfloat16", "int8", "fp8"],
                    help="serve_dtype for the engine (int8/fp8 need a "
                         "task=quantize calibrated --model-in or a "
                         "quantized --artifact); the record is "
                         "dtype-tagged. Default: the artifact's "
                         "sealed dtype, else float32")
    ap.add_argument("--device-mem", action="store_true",
                    help="add a device-memory-per-model column to "
                         "every sweep point (resident bytes from the "
                         "weight_residency record) and exit 3 if "
                         "resident bytes GROW across sweep points — "
                         "a weight-residency leak guard")
    ap.add_argument("--serve-weight-residency", default="",
                    choices=["", "0", "1"],
                    help="force serve_weight_residency for the sweep "
                         "(default: the config/trainer default, 1) — "
                         "0 gives the legacy per-dispatch "
                         "fold/quantize baseline for before/after "
                         "records")
    ap.add_argument("--embed-search", action="store_true",
                    help="retrieval product scenario "
                         "(doc/retrieval.md): build an indexed "
                         "bundle via task=build_index, boot a fleet "
                         "from it, and drive embed-only / "
                         "search-only / fanned embed->search "
                         "closed loops through the binary op-suffix "
                         "grammar; the record carries rows/s + "
                         "p50/p99 per scenario and a recall "
                         "spot-check vs the NumPy oracle (exit 1 on "
                         "post-warmup compiles, 3 on failed "
                         "requests or a recall miss)")
    ap.add_argument("--dev", default="gpu", choices=["gpu", "cpu"],
                    help="where every session, fleet, continual loop "
                         "and replica the tool starts computes (the "
                         "CLI's dev key): gpu (default; raises when "
                         "there is none) or cpu")
    ap.add_argument("--peak-tflops", type=float, default=0.0,
                    help="chip peak TFLOP/s for the serve dtype; when "
                         "set, every sweep point carries an MFU column "
                         "from the model_info analytic FLOPs — "
                         "comparable with bench.py's train MFU")
    args = ap.parse_args(argv)
    if args.serve_dtype in ("int8", "fp8") and not args.conf \
            and not args.artifact:
        ap.error("--serve-dtype %s needs a task=quantize calibrated "
                 "snapshot: pass --conf/--model-in or --artifact (the "
                 "synthetic MLP has no calibration ranges)"
                 % args.serve_dtype)
    if args.artifact and args.tenants:
        ap.error("--artifact drives the closed-loop sweep; drop "
                 "--tenants (fleet configs name bundles in "
                 "serve_models instead)")
    if args.replicas and args.tenants:
        ap.error("--replicas and --tenants are separate scenarios; "
                 "run them as two invocations")
    if args.generations and (args.replicas or args.tenants
                             or args.artifact):
        ap.error("--generations is its own scenario; drop "
                 "--replicas/--tenants/--artifact")
    if args.autoscale_soak and not args.replicas:
        ap.error("--autoscale-soak needs --replicas")
    if (args.coalesce_ms or args.fleet_baseline) \
            and not args.replicas:
        ap.error("--coalesce-ms/--fleet-baseline need --replicas")
    if args.balancers and (args.replicas or args.tenants
                           or args.generations or args.artifact):
        ap.error("--balancers is its own scenario (front tier over "
                 "null replicas); drop "
                 "--replicas/--tenants/--generations/--artifact")
    if args.embed_search and (args.replicas or args.tenants
                              or args.generations or args.balancers
                              or args.artifact):
        ap.error("--embed-search is its own scenario (it builds and "
                 "seals its own indexed bundle); drop "
                 "--replicas/--tenants/--generations/--balancers/"
                 "--artifact")

    from cxxnet_tpu_torch.device import resolve_device
    from cxxnet_tpu_torch.monitor import MemorySink, Monitor
    # no GPU and no --dev cpu: raise here, never carry on on the CPU;
    # the records' platform is the resolved device's, in the
    # reference's vocabulary
    dev = resolve_device(_device(args))
    platform = "gpu" if dev.type == "cuda" else "cpu"
    sink = MemorySink()
    monitor = Monitor(sink)
    if args.balancers:
        rec, clean, _zero = run_front_tier(args, monitor, sink)
        rec["platform"] = platform
        out = json.dumps(rec, sort_keys=True)
        print(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        # exit-code convention (bench.py): 3 = a request failed, a
        # door kill dropped traffic, or the quota bound was breached;
        # no engines run so recompiles cannot occur
        return 0 if clean else 3
    if args.embed_search:
        rec, clean, zero_recompiles = run_embed_search(
            args, monitor, sink)
        rec["platform"] = platform
        out = json.dumps(rec, sort_keys=True)
        print(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        # exit-code convention: 1 = post-warmup compiles, 3 = a
        # request failed or the recall spot-check missed the oracle
        if not zero_recompiles:
            return 1
        return 0 if clean else 3
    if args.generations:
        rec, clean, zero_recompiles = run_continual_soak(
            args, monitor, sink)
        rec["platform"] = platform
        out = json.dumps(rec, sort_keys=True)
        print(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        # exit-code convention: 1 = post-warmup compiles, 3 = the
        # soak dropped requests / failed a deploy / eval regressed
        if not zero_recompiles:
            return 1
        return 0 if clean else 3
    if args.replicas:
        rec, clean, zero_recompiles = run_multi_replica(
            args, monitor, sink)
        rec["platform"] = platform
        out = json.dumps(rec, sort_keys=True)
        print(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        # exit-code convention (bench.py): 1 = the capture itself is
        # bad (post-warmup recompiles), 2 = argparse usage, 3 = the
        # fleet dropped requests / breached its SLO / failed the soak
        if not zero_recompiles:
            return 1
        return 0 if clean else 3
    if args.tenants:
        rec, slo_ok, zero_recompiles = run_multi_tenant(
            args, monitor, sink)
        rec["platform"] = platform
        out = json.dumps(rec, sort_keys=True)
        print(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        # exit-code convention (bench.py): 1 = the capture itself is
        # bad (post-warmup recompiles), 2 = argparse usage, 3 = the
        # measured fleet breached its latency SLO
        if not zero_recompiles:
            return 1
        return 0 if slo_ok else 3
    rec_dtype = args.serve_dtype or "float32"
    if not args.serve_dtype and args.conf and not args.artifact:
        # the conf's serve_dtype drives the engine when the flag is
        # unset — the record tag must say what was actually measured
        # (cross-dtype rows/s comparisons are not a signal)
        from cxxnet_tpu_torch.nnet.quantize import normalize_serve_dtype
        from cxxnet_tpu_torch.utils.config import parse_config_file
        for k, v in parse_config_file(args.conf):
            if k == "serve_dtype":
                rec_dtype = normalize_serve_dtype(v)
    cold_start = None
    if args.artifact:
        # cold-start columns FIRST (each is a fresh boot with clean
        # telemetry); the artifact column is the headline, the
        # snapshot column (when a --conf/--model-in baseline is
        # available) is what it saves
        cold_start = [measure_cold_start(args, monitor, sink,
                                         "artifact")]
        if args.conf and args.model_in:
            cold_start.append(measure_cold_start(args, monitor, sink,
                                                 "snapshot"))
        for c in cold_start:
            print("# cold-start via %s: boot %.2fs, first reply "
                  "%.1f ms, ttfr %.2fs, compiles %d"
                  % (c["via"], c["boot_s"], c["first_reply_ms"],
                     c["time_to_first_reply_s"], c["compile_events"]),
                  file=sys.stderr)
        if not args.serve_dtype:
            from cxxnet_tpu_torch.artifact.bundle import bundle_manifest
            rec_dtype = bundle_manifest(args.artifact)["serve_dtype"]
    points = []
    for clients in [int(t) for t in args.clients.split(",") if t]:
        t0 = time.time()
        pt = sweep_point(args, clients, monitor, sink)
        pt["wall_s"] = round(time.time() - t0, 2)
        points.append(pt)
        print("# clients=%d: %.1f rows/s, p50 %.2f ms, p99 %.2f ms, "
              "fill %.2f, compiles %d"
              % (clients, pt["rows_per_sec"], pt["latency_p50_ms"],
                 pt["latency_p99_ms"], pt["fill_rate"],
                 pt["compile_events"]), file=sys.stderr)
    rec = {
        "name": "serve_bench",
        "t": time.time(),
        "platform": platform,
        "model": args.artifact or args.conf
        or "synthetic_mlp_256_64_10",
        "dtype": rec_dtype,
        "buckets": args.buckets,
        "max_delay_ms": args.max_delay_ms,
        "requests_per_client": args.requests,
        "request_rows": args.request_rows,
        "sweep": points,
        "zero_recompiles": all(p["compile_events"] == 0
                               for p in points),
    }
    if cold_start is not None:
        rec["cold_start"] = cold_start
    if args.serve_weight_residency:
        rec["weight_residency"] = int(args.serve_weight_residency)
    out = json.dumps(rec, sort_keys=True)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    if not rec["zero_recompiles"]:
        return 1
    if args.device_mem:
        # leak guard: every sweep point boots a FRESH session of the
        # same model, so its resident bytes must not grow point over
        # point — growth means freeze-time buffers leak across boots
        mem = [p["device_mem_bytes"] for p in points
               if p.get("device_mem_bytes")]
        if any(b > a for a, b in zip(mem, mem[1:])):
            print("# residency leak: resident bytes grew across "
                  "sweep points: %s" % mem, file=sys.stderr)
            return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
