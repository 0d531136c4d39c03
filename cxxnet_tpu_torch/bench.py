"""Benchmark: images/sec on ImageNet AlexNet, Inception-BN and kaiming
(counterpart of the repo-root ``bench.py``, on the port).

Measures the full training step (forward, backward, sgd) at steady state:
``NetTrainer.run_steps`` runs N update steps on one batch resident on
the device, the reference's ``test_skipread`` pure-compute mode
(iter_batch_proc-inl.hpp:21). Compute is bfloat16 with float32 master
weights (``--dtype`` / ``--grad-dtype`` select float32).

The reference publishes no throughput number (BASELINE.md); 1500 img/s
is the commonly reported cxxnet-era single-GPU (Titan X) AlexNet
figure, kept as the reference package's fixed comparison anchor; it was
not measured here.

Capture is self-validating: every model times TWO windows and reports
the faster, retries once when they disagree by >1.5x, and emits
``suspect: true`` instead of a silent bad number when even the retry
disagrees. Per-window dts and the max/min spread ride in the JSON so a
record carries its own error bars.

Runs on the GPU; ``--extra dev=cpu`` (the ``dev`` key the port's CLI
reads) runs it on the CPU, which times the CPU::

    python -m cxxnet_tpu_torch.bench                 # all models
    python -m cxxnet_tpu_torch.bench --model inception_bn --steps 50
    python -m cxxnet_tpu_torch.bench --model alexnet --steps 1 \\
        --batch 4 --extra dev=cpu

Exit status: 0; 1 when ``--compare`` finds a regression; 2 on a usage
error or a corrupt ``--compare`` record; 3 when a ``--compare`` verdict
is suspect. The multi-GPU flags (``--hosts``, ``--virtual-devices``,
``--hosts-rows``, ``--hosts-batch``, ``--grad-sync overlap``,
``--grad-sync-bucket-mb``, ``--optim-shard 1``) raise
``NotPortedError``.
"""

import gc
import json
import os
import tempfile
import time

import numpy as np

BASELINE_IMAGES_PER_SEC = 1500.0

# Two timed windows that disagree by more than this ratio mean one of
# them hit a stall (a window only ever reads slow, never fast), so 1.5x
# is far outside run-to-run noise.
STALL_RATIO = 1.5


def capture(window_fn, max_ratio=STALL_RATIO):
    """Self-validating timed capture over ``window_fn() -> dt seconds``.

    Times two windows; if they disagree by more than ``max_ratio`` one
    of them stalled, so a third window breaks the tie. The best (min)
    dt is the measurement — throughput noise on a shared device is
    one-sided (stalls only ever slow a window down). ``suspect`` is
    True when even after the retry the two best windows still disagree
    by more than ``max_ratio``: no trustworthy number exists and the
    consumer must not treat ``best`` as steady-state.

    Returns ``(best_dt, dts, suspect)`` with ``dts`` in capture order.
    """
    dts = [window_fn(), window_fn()]
    if max(dts) / min(dts) > max_ratio:
        dts.append(window_fn())
    suspect = agreeing_spread(dts) > max_ratio
    return min(dts), dts, suspect


def agreeing_spread(dts):
    """Spread (max/min ratio) of the two BEST windows: a recovered
    stall's discarded third window must not inflate the error bar the
    --compare tolerance is derived from."""
    s = sorted(dts)
    return s[1] / s[0]


def load_compare_record(path):
    """Parse + validate a prior bench record for --compare, BEFORE the
    minutes-long sweep. Returns the old ``models`` map; raises
    ValueError on anything corrupt: no usable record at all, or a
    model value that is not a finite number > 0 (a 0.0 in a hand-edited
    record used to surface as a ZeroDivisionError after the sweep).
    Single-model records keep their OWN capture fields (spread/suspect)
    so the tolerance doesn't silently fall back to the 1.2 floor."""
    with open(path) as f:
        prev = json.load(f)
    prev = prev.get("parsed") or prev if isinstance(prev, dict) else prev
    if not isinstance(prev, dict) or (
            "models" not in prev and "value" not in prev):
        raise ValueError("%s has no usable bench record" % path)
    if prev.get("models"):
        old = prev["models"]
    else:
        old = {"alexnet": {k: prev[k]
                           for k in ("value", "spread", "suspect",
                                     "dtype", "topology")
                           if k in prev}}
    for m, v in old.items():
        ov = v.get("value") if isinstance(v, dict) else v
        if (not isinstance(ov, (int, float)) or isinstance(ov, bool)
                or not np.isfinite(ov) or not ov > 0):
            raise ValueError(
                "%s: model %r has corrupt value %r (must be a finite "
                "number > 0)" % (path, m, ov))
    return old


def compare_models(old, new, floor=1.2):
    """Spread-aware per-model comparison of two bench ``models`` maps.

    ``old``/``new`` values are either bare img/s floats (early records)
    or capture dicts with ``value``/``spread``/``suspect``. A delta is
    flagged only when it exceeds every recorded spread and the noise
    ``floor`` — the record history becomes a regression harness instead
    of numbers a human eyeballs. Returns {model: verdict-dict}.
    """
    def parts(v):
        if isinstance(v, dict):
            return (v.get("value"), v.get("spread", 1.0),
                    bool(v.get("suspect")), v.get("dtype"))
        return float(v), 1.0, False, None

    out = {}
    for m in sorted(set(old) & set(new)):
        ov, ospread, osus, odt = parts(old[m])
        nv, nspread, nsus, ndt = parts(new[m])
        tol = max(ospread, nspread, floor)
        if osus or nsus:
            verdict = "suspect"
        elif nv * tol < ov:
            verdict = "regression"
        elif nv > ov * tol:
            verdict = "improvement"
        else:
            verdict = "ok"
        out[m] = {"old": round(ov, 1), "new": round(nv, 1),
                  "ratio": round(nv / ov, 3), "tolerance": round(tol, 3),
                  "verdict": verdict,
                  # dtype annotation: pre-dtype records read "unknown"
                  # (they are comparable by convention — the sweep ran
                  # bf16 long before it was tagged)
                  "old_dtype": odt or "unknown",
                  "new_dtype": ndt or "unknown"}
    return out


def expected_topology(batch):
    """The topology this process WILL measure a model at: the port
    trains on one device, which the reference's record writes as a
    one-device data axis. Recorded per model entry and compared against
    prior records up front."""
    return {"mesh": {"data": 1, "model": 1},
            "process_count": 1,
            "device_count": 1}


def topology_mismatches(old):
    """Models whose prior record carries a topology (mesh shape /
    process count / device count) DIFFERENT from what this sweep will
    measure — img/s across topologies is not a regression signal, so
    cross-topology diffs are refused (exit 2, like the dtype guard)
    unless --allow-topology-mismatch. Untagged old records (pre-
    topology rounds) compare freely."""
    out = []
    for m, v in sorted(old.items()):
        ot = v.get("topology") if isinstance(v, dict) else None
        if ot and m in MODELS:
            exp = expected_topology(MODELS[m][1])
            if ot != exp:
                out.append((m, ot, exp))
    return out


def dtype_mismatches(old, new_dtype):
    """Models whose prior record carries a compute dtype DIFFERENT from
    the dtype this sweep will measure — cross-dtype img/s comparisons
    are refused (exit 2) unless --allow-dtype-mismatch. Untagged old
    records (pre-dtype rounds) compare freely."""
    out = []
    for m, v in sorted(old.items()):
        odt = v.get("dtype") if isinstance(v, dict) else None
        if odt and odt != new_dtype:
            out.append((m, odt))
    return out


def sync_mismatches(old, new_grad_sync, new_optim_shard):
    """Models whose prior record carries a gradient-sync mode or
    optimizer-shard setting DIFFERENT from this sweep's — a
    grad_sync=overlap capture must never silently diff against a fused
    baseline (the schedule is the variable under test), and ZeRO-1
    changes the update's memory traffic. Refused (exit 2, the
    dtype/topology convention) unless --allow-sync-mismatch; untagged
    old records (pre-grad_sync rounds) compare freely."""
    out = []
    for m, v in sorted(old.items()):
        if not isinstance(v, dict):
            continue
        osync = v.get("grad_sync")
        if osync is not None and osync != new_grad_sync:
            out.append((m, "grad_sync", osync, new_grad_sync))
        oshard = v.get("optim_shard")
        if oshard is not None and int(oshard) != int(new_optim_shard):
            out.append((m, "optim_shard", oshard, new_optim_shard))
    return out


# bench model -> (builder in cxxnet_tpu_torch.models, default batch,
# image size, model-specific config); image sizes follow the reference
# confs: AlexNet 227 (ImageNet/README.md), Inception-BN and kaiming 224.
#
# inception_bn carries the layout/fusion knobs of the reference's entry:
# bn_fuse_relu collapses the ~30 BN+relu epilogue chains,
# channel_pad=128 pads the narrow conv outputs to multiples of 128
# channels (overhead-guarded), input_layout=rowmajor is accepted and
# changes nothing here (the port's batches are row-major already).
# alexnet_up2 is the reference's canonical update_period=2 batch-128
# AlexNet config (ImageNet/alexnet.conf); the headline metric stays
# the batch-256 'alexnet' entry.
MODELS = {
    "alexnet": ("alexnet", 256, 227, ()),
    "alexnet_up2": ("alexnet", 128, 227,
                    (("update_period", "2"),
                     ("input_layout", "rowmajor"))),
    "inception_bn": ("inception_bn", 128, 224,
                     (("bn_fuse_relu", "1"),
                      ("channel_pad", "128"),
                      ("channel_pad_max_overhead", "0.34"),
                      ("input_layout", "rowmajor"))),
    "kaiming": ("kaiming", 128, 224, ()),
}


def _device_of(extra):
    """The device the ``dev`` pair among ``extra`` names (the last one
    wins, as in a config), or None: the GPU."""
    from cxxnet_tpu_torch.device import named_device
    devs = [v for k, v in extra if k == "dev"]
    return named_device(devs[-1]) if devs else None


def measure(steps: int = 200, batch: int = None, model: str = "alexnet",
            dtype: str = "bfloat16",
            grad_dtype: str = "bfloat16",
            extra: tuple = (), peak_tflops: float = 0.0,
            grad_sync: str = "fused",
            optim_shard: int = 0) -> dict:
    """One model's capture record (see the module docstring): img/s of
    ``steps`` resident-batch training steps per window, the windows,
    spread, suspect, whether a window paid a first-use cost, the kernel
    libraries ``precompile`` built or loaded, the analytic FLOPs, the
    layout record, the dtype / topology / sync tags, the kernel
    launches a step and, on the GPU, the peak device memory."""
    import torch
    import cxxnet_tpu_torch.models as zoo
    from cxxnet_tpu_torch.io import DataBatch
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.monitor import MemorySink, Monitor
    from cxxnet_tpu_torch.monitor.schema import validate_records
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config

    builder_name, default_batch, size, model_cfg = MODELS[model]
    if batch is None:
        batch = default_batch
    builder = getattr(zoo, builder_name)
    t = NetTrainer(parse_config(builder(nclass=1000, batch_size=batch,
                                        image_size=size))
                   + [("eval_train", "0"), ("dtype", dtype),
                      ("grad_dtype", grad_dtype),
                      ("momentum_dtype", "bfloat16"), ("silent", "1"),
                      ("grad_sync", grad_sync),
                      ("optim_shard", str(int(optim_shard)))]
                   + list(model_cfg) + list(extra),
                   device=_device_of(extra))
    t.init_model()
    cuda = t.device.type == "cuda"

    rng = np.random.RandomState(0)
    b = t.device_put_batch(DataBatch(
        data=rng.rand(batch, size, size, 3).astype(np.float32),
        label=rng.randint(0, 1000, (batch, 1)).astype(np.float32)))

    # throughput comes from the telemetry stream, not a re-derived
    # timer: the monitored trainer times each run_steps dispatch to a
    # device sync, and every record is schema-validated
    sink = MemorySink()
    t.set_monitor(Monitor(sink))            # emits model_info + layout
    validate_records(sink.records)
    recs = {r["event"]: r for r in sink.records}
    flops_img = recs.get("model_info", {}).get(
        "train_flops_per_example", 0.0)
    layout_rec = {k: v for k, v in recs.get("layout", {}).items()
                  if k not in ("event", "t")}
    # build the kernels and pay cuDNN's first choices up front; the
    # warmup pays the run_steps dispatch's first sighting, so the timed
    # windows never see a first-use cost (compile=False on every step)
    programs = len(t.precompile())
    t.run_steps(b, steps)                   # warmup (same n)
    if cuda:
        torch.cuda.synchronize(t.device)
        torch.cuda.reset_peak_memory_stats(t.device)

    compiled_in_window = []
    kernels.reset_launch_counts()

    def window():
        sink.clear()
        t.run_steps(b, steps)
        validate_records(sink.records)
        (rec,) = [r for r in sink.records if r["event"] == "step"]
        compiled_in_window.append(bool(rec["compile"]))
        return rec["wall_ms"] / 1e3

    best, dts, suspect = capture(window)
    launches = kernels.launch_counts()
    ips = steps * batch / best
    out = {
        "value": round(ips, 1),
        "dt": [round(d, 4) for d in dts],
        "spread": round(agreeing_spread(dts), 3),
        "suspect": suspect,
        "zero_recompiles": not any(compiled_in_window),
        # the kernel libraries precompile built or loaded (the port's
        # first-use cost; the reference counts XLA executables here)
        "precompile_programs": programs,
        "flops_per_img": flops_img,
        "layout": layout_rec,
        # dtype-tagged capture: --compare refuses to diff records
        # measured in different compute dtypes
        "dtype": dtype,
        # topology-tagged capture: --compare refuses cross-topology
        # diffs the same way
        "topology": expected_topology(batch),
        # sync-tagged capture: --compare refuses an overlap-vs-fused
        # (or sharded-vs-replicated) diff the same way
        "grad_sync": grad_sync,
        "optim_shard": int(optim_shard),
        # hand-kernel launches a step over the timed windows
        "launches_per_step": {k: v / (steps * len(dts))
                              for k, v in sorted(launches.items()) if v},
        "peak_mem_gb": torch.cuda.max_memory_allocated(t.device) / 1e9
        if cuda else None,
        "device": torch.cuda.get_device_name(t.device) if cuda else "cpu",
    }
    if peak_tflops > 0 and flops_img > 0:
        out["mfu"] = round(ips * flops_img / (peak_tflops * 1e12), 4)
    return out


def _make_rec(path: str, n: int = 2048, size: int = 256) -> None:
    """Pack n synthetic jpegs into a recordio archive (once, cached)."""
    if os.path.exists(path):
        return
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "--pipeline writes JPEG records with cv2, which is not "
            "installed here (%s); --pipeline-raw needs no JPEG codec"
            % e) from e
    from cxxnet_tpu_torch.io.recordio import (RecordIOWriter,
                                              pack_image_record)
    rng = np.random.RandomState(0)
    w = RecordIOWriter(path)
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3), np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        if not ok:
            raise RuntimeError("cv2.imencode failed on image %d" % i)
        w.write_record(pack_image_record(i, float(i % 1000),
                                         bytes(buf.tobytes())))
    w.close()


def _make_raw_rec(path: str, n: int = 2048, size: int = 256) -> None:
    """Pack n synthetic RAW uint8 tensors (no jpeg): the decode-free
    archive for --pipeline-raw."""
    if os.path.exists(path):
        return
    from cxxnet_tpu_torch.io.recordio import (RecordIOWriter,
                                              pack_raw_tensor_record)
    rng = np.random.RandomState(0)
    w = RecordIOWriter(path)
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3), np.uint8)
        w.write_record(pack_raw_tensor_record(i, float(i % 1000), img))
    w.close()


def measure_pipeline(batch: int = 256, rec_path: str = None,
                     n_images: int = 2048, raw: bool = False,
                     dispatch_period: int = 8, precompile: bool = True,
                     measure_pure: bool = True,
                     measure_eval: bool = True, extra: tuple = ()):
    """End-to-end throughput: imgrec -> decode pool -> augment (rand
    crop 227 + mirror into the batch ring) -> batch -> threadbuffer
    prefetch (the copy to the device in the prefetch thread) -> train
    step. Returns a dict: img/s end-to-end, duty cycle vs pure compute,
    pure img/s, eval img/s, plus the pipeline telemetry (buffer-reuse
    rate, H2D overlap ratio, io_wait p50/p99, precompile wall time).

    raw=True uses pre-packed raw uint8 tensor records (no jpeg in the
    loop), bounding the non-decode pipeline overhead. The archive goes
    to the temporary directory unless ``rec_path`` names one."""
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.io.iter_batch import (enable_chain_wait_stats,
                                                pipeline_snapshot)
    from cxxnet_tpu_torch.models import alexnet
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config

    if rec_path is None:
        rec_path = os.path.join(tempfile.gettempdir(), "bench.rec")
    # archive path carries the image count: the writers cache by bare
    # path existence, so a smaller archive from an earlier run must not
    # silently serve a larger request
    if raw:
        rec_path = rec_path.replace(".rec", "_raw_%d.rec" % n_images)
        _make_raw_rec(rec_path, n_images)
    else:
        rec_path = rec_path.replace(".rec", "_%d.rec" % n_images)
        _make_rec(rec_path, n_images)
    t = NetTrainer(parse_config(alexnet(nclass=1000, batch_size=batch,
                                        image_size=227))
                   + [("eval_train", "0"), ("dtype", "bfloat16"),
                      ("precompile_dtype", "uint8")] + list(extra),
                   device=_device_of(extra))
    t.init_model()
    it = create_iterator(
        [("iter", "imgrec"), ("path_imgrec", rec_path),
         ("decode_uint8", "1"), ("rand_crop", "1"), ("rand_mirror", "1"),
         ("silent", "1"), ("shuffle", "0"), ("iter", "threadbuffer")],
        [("batch_size", str(batch)), ("input_shape", "3,227,227")])
    it.init()
    if hasattr(it, "set_transform"):
        # the copy to the device in the prefetch thread, from a pinned
        # ring on the GPU
        it.set_transform(t.device_put_batch,
                         pin_memory=t.device.type == "cuda")
    hist = enable_chain_wait_stats(it)
    precompile_wall_s, programs = 0.0, 0
    if precompile:
        t0 = time.perf_counter()
        programs = len(t.precompile())
        precompile_wall_s = time.perf_counter() - t0

    def run_epoch(max_batches=None):
        """The CLI train loop's windowed dispatch (update_many every
        dispatch_period batches, per-batch tail)."""
        n, window = 0, []
        it.before_first()
        for b in it:
            window.append(b)
            n += b.batch_size - b.num_batch_padd
            if len(window) >= dispatch_period:
                t.update_many(window)
                window = []
            if max_batches and n >= max_batches * batch:
                break
        for b in window:
            t.update(b)
        _ = t.last_loss
        return n

    # warmup epoch fragment: pay what precompile didn't cover and fill
    # the prefetch queue
    run_epoch(max_batches=dispatch_period + 1)
    pipeline_snapshot(it)                    # drop warmup counters
    if hist is not None:
        hist.reset()

    start = time.perf_counter()
    nimg = run_epoch()
    dt = time.perf_counter() - start
    e2e = nimg / dt
    telemetry = pipeline_snapshot(it) or {}
    io_snap = hist.snapshot() if hist is not None else {}

    # eval pass through the SAME pipeline (nnet_impl-inl.hpp:241-276
    # evaluates through the training input path)
    eval_ips = 0.0
    if measure_eval:
        start = time.perf_counter()
        nimg = 0
        it.before_first()
        for b in it:
            t.predict(b)
            nimg += b.batch_size - b.num_batch_padd
        eval_ips = nimg / (time.perf_counter() - start)
    it.close()

    # pure-compute reference on a resident batch (test_skipread mode)
    pure = measure(steps=50, batch=batch, extra=extra)["value"] \
        if measure_pure else e2e
    return {
        "e2e": e2e,
        "duty_cycle": min(e2e / pure, 1.0),
        "pure": pure,
        "eval_ips": eval_ips,
        "buffer_reuse_rate": telemetry.get("buffer_reuse_rate", 0.0),
        "h2d_overlap_ratio": telemetry.get("h2d_overlap_ratio", 0.0),
        "io_wait_p50_ms": io_snap.get("p50_ms", 0.0),
        "io_wait_p99_ms": io_snap.get("p99_ms", 0.0),
        "io_wait_count": io_snap.get("count", 0),
        "precompile_wall_ms": round(precompile_wall_s * 1e3, 1),
        "precompile_programs": programs,
    }


def _refuse_multi_gpu(args) -> None:
    """The flags of the reference's multi-device paths, before any
    measurement."""
    from cxxnet_tpu_torch.utils.config import NotPortedError, Roadmap
    for flag, on in (("--hosts", args.hosts),
                     ("--virtual-devices", args.virtual_devices > 0),
                     ("--hosts-rows", args.hosts_rows is not None),
                     ("--hosts-batch", args.hosts_batch is not None),
                     ("--grad-sync overlap", args.grad_sync != "fused"),
                     ("--grad-sync-bucket-mb",
                      args.grad_sync_bucket_mb != 0.0),
                     ("--optim-shard 1", args.optim_shard)):
        if on:
            raise NotPortedError("bench %s" % flag, Roadmap.MULTI_GPU)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m cxxnet_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--pipeline", action="store_true",
                    help="end-to-end imgrec pipeline mode (JPEG records: "
                         "needs cv2)")
    ap.add_argument("--pipeline-raw", action="store_true",
                    help="pipeline mode over pre-decoded raw-tensor "
                         "records (no jpeg): bounds non-decode overhead")
    ap.add_argument("--model", choices=sorted(MODELS), default=None,
                    help="measure one model (default: all, with the "
                         "AlexNet headline)")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per timed window (default 200)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--grad-dtype", choices=["float32", "bfloat16"],
                    default="bfloat16",
                    help="gradient/cotangent dtype (f32 master weights "
                         "either way); bf16 is the bench default")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="bfloat16",
                    help="compute dtype of the measured step; every "
                         "record is dtype-tagged and --compare refuses "
                         "cross-dtype diffs")
    ap.add_argument("--allow-dtype-mismatch", action="store_true",
                    help="compare img/s across records measured in "
                         "different compute dtypes anyway (the rows "
                         "stay dtype-annotated)")
    ap.add_argument("--allow-topology-mismatch", action="store_true",
                    help="compare img/s across records measured at "
                         "different mesh/process topologies anyway "
                         "(the rows stay topology-annotated)")
    ap.add_argument("--grad-sync", choices=["fused", "overlap"],
                    default="fused",
                    help="gradient reduction mode (overlap: not ported, "
                         "multi-GPU)")
    ap.add_argument("--grad-sync-bucket-mb", type=float, default=0.0,
                    help="reduction-group bucket size for "
                         "grad_sync=overlap (not ported, multi-GPU)")
    ap.add_argument("--optim-shard", type=int, choices=[0, 1],
                    default=0,
                    help="ZeRO-1 optimizer-state sharding (1: not "
                         "ported, multi-GPU)")
    ap.add_argument("--allow-sync-mismatch", action="store_true",
                    help="compare img/s across records measured under "
                         "different grad_sync/optim_shard settings "
                         "anyway (the rows stay sync-annotated)")
    ap.add_argument("--hosts", metavar="H1,H2,..", default=None,
                    help="multi-host scaling sweep (not ported, "
                         "multi-GPU)")
    ap.add_argument("--virtual-devices", type=int, default=0,
                    help="virtual devices for --hosts (not ported, "
                         "multi-GPU)")
    ap.add_argument("--hosts-rows", type=int, default=None,
                    help="dataset rows for the --hosts sweep (not "
                         "ported, multi-GPU)")
    ap.add_argument("--hosts-batch", type=int, default=None,
                    help="global batch for the --hosts sweep (not "
                         "ported, multi-GPU)")
    ap.add_argument("--peak-tflops", type=float, default=0.0,
                    help="the device's peak TFLOP/s for the compute "
                         "dtype; when set, each model's record carries "
                         "whole-step MFU from the analytic FLOP count")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="K=V",
                    help="extra config pairs for perf experiments "
                         "(e.g. --extra remat=conv); --extra dev=cpu "
                         "runs on the CPU")
    ap.add_argument("--compare", metavar="BENCH.json", default=None,
                    help="after measuring all models, diff against a "
                         "prior bench record and flag per-model deltas "
                         "beyond recorded spread; exit 1 on regression, "
                         "3 when any verdict is suspect (2 = usage/"
                         "corrupt record, argparse's)")
    args = ap.parse_args(argv)
    if args.compare and (args.model or args.pipeline or
                         args.pipeline_raw or args.hosts):
        ap.error("--compare runs the all-model sweep; drop --model/"
                 "--pipeline/--hosts")
    for kv in args.extra:
        if "=" not in kv:
            ap.error("--extra expects K=V, got %r" % kv)
    extra_cfg = tuple(tuple(kv.split("=", 1)) for kv in args.extra)
    _refuse_multi_gpu(args)
    if args.pipeline or args.pipeline_raw:
        cap = measure_pipeline(raw=args.pipeline_raw, extra=extra_cfg)
        print(json.dumps({
            "metric": "end-to-end images/sec (imgrec pipeline%s)"
                      % (", raw records" if args.pipeline_raw else ""),
            "value": round(cap["e2e"], 1),
            "unit": "images/sec",
            "duty_cycle_vs_pure_compute": round(cap["duty_cycle"], 3),
            "pure_compute_images_per_sec": round(cap["pure"], 1),
            "eval_images_per_sec": round(cap["eval_ips"], 1),
            "buffer_reuse_rate": round(cap["buffer_reuse_rate"], 4),
            "h2d_overlap_ratio": round(cap["h2d_overlap_ratio"], 4),
            "io_wait_p50_ms": cap["io_wait_p50_ms"],
            "io_wait_p99_ms": cap["io_wait_p99_ms"],
            "precompile_wall_ms": cap["precompile_wall_ms"],
        }))
        return
    if args.model is not None:
        model = args.model
        steps = args.steps if args.steps is not None else 200
        cap = measure(steps=steps, batch=args.batch, model=model,
                      dtype=args.dtype,
                      grad_dtype=args.grad_dtype, extra=extra_cfg,
                      peak_tflops=args.peak_tflops,
                      grad_sync=args.grad_sync,
                      optim_shard=args.optim_shard)
        # 'AlexNet' spelling keeps the canonical metric name
        name = "AlexNet" if model == "alexnet" else model
        rec = {
            "metric": "images/sec/chip on ImageNet %s" % name,
            "value": cap["value"],
            "unit": "images/sec/chip",
            "vs_baseline": round(cap["value"] / BASELINE_IMAGES_PER_SEC,
                                 3),
            "dt": cap["dt"],
            "spread": cap["spread"],
            "suspect": cap["suspect"],
            "zero_recompiles": cap["zero_recompiles"],
            "layout": cap["layout"],
            "dtype": cap["dtype"],
            "grad_sync": cap["grad_sync"],
            "optim_shard": cap["optim_shard"],
            "launches_per_step": cap["launches_per_step"],
            "peak_mem_gb": cap["peak_mem_gb"],
            "device": cap["device"],
        }
        if "mfu" in cap:
            rec["mfu"] = cap["mfu"]
        print(json.dumps(rec))
        return
    # default: measure ALL models sequentially (one JSON line; the
    # headline metric/value stays AlexNet, per-model numbers ride in
    # "models" so non-flagship regressions are machine-visible)
    if args.batch is not None:
        ap.error("--batch needs --model (per-model defaults differ)")
    old = None
    if args.compare:
        # parse + validate BEFORE the minutes-long sweep so a corrupt
        # record (e.g. "parsed": null from a failed round) fails fast
        try:
            old = load_compare_record(args.compare)
        except ValueError as e:
            ap.error(str(e))
        # refuse cross-dtype comparisons BEFORE the sweep: img/s
        # measured in different compute dtypes is not a regression
        # signal (exit 2 — a usage error, like a corrupt record)
        mism = dtype_mismatches(old, args.dtype)
        if mism and not args.allow_dtype_mismatch:
            ap.error(
                "cannot compare across dtypes: %s (this sweep measures "
                "%s); pass --allow-dtype-mismatch to diff anyway"
                % (", ".join("%s is %s" % mv for mv in mism),
                   args.dtype))
        # same rule for topology (exit 2, before the sweep)
        tmism = topology_mismatches(old)
        if tmism and not args.allow_topology_mismatch:
            ap.error(
                "cannot compare across topologies: %s; pass "
                "--allow-topology-mismatch to diff anyway"
                % ", ".join("%s was %r, this sweep is %r" % mt
                            for mt in tmism))
        # and for the gradient-sync mode / ZeRO-1 state sharding
        # (exit 2, before the sweep)
        smism = sync_mismatches(old, args.grad_sync, args.optim_shard)
        if smism and not args.allow_sync_mismatch:
            ap.error(
                "cannot compare across grad-sync settings: %s; pass "
                "--allow-sync-mismatch to diff anyway"
                % ", ".join("%s %s was %r, this sweep is %r" % ms
                            for ms in smism))
    import torch
    models = {}
    for m in sorted(MODELS):
        steps = args.steps if args.steps is not None else 200
        models[m] = measure(steps=steps, model=m, dtype=args.dtype,
                            grad_dtype=args.grad_dtype, extra=extra_cfg,
                            peak_tflops=args.peak_tflops,
                            grad_sync=args.grad_sync,
                            optim_shard=args.optim_shard)
        gc.collect()                     # free device memory before the
        if torch.cuda.is_available():    # next model
            torch.cuda.empty_cache()
    head = models["alexnet"]
    out = {
        "metric": "images/sec/chip on ImageNet AlexNet",
        "value": head["value"],
        "unit": "images/sec/chip",
        "vs_baseline": round(head["value"] / BASELINE_IMAGES_PER_SEC, 3),
        "suspect": any(c["suspect"] for c in models.values()),
        "dtype": args.dtype,
        "grad_sync": args.grad_sync,
        "optim_shard": args.optim_shard,
        "models": models,
    }
    # input-pipeline telemetry rides in every sweep record: a small
    # raw-record run — decode-free, so it measures the pipeline itself,
    # not the JPEG codec; dispatch_period=1 keeps it on per-batch
    # updates
    try:
        pcap = measure_pipeline(batch=128, raw=True, n_images=256,
                                dispatch_period=1,
                                measure_pure=False, measure_eval=False,
                                extra=extra_cfg)
        out["pipeline"] = {
            "e2e_images_per_sec": round(pcap["e2e"], 1),
            "buffer_reuse_rate": round(pcap["buffer_reuse_rate"], 4),
            "h2d_overlap_ratio": round(pcap["h2d_overlap_ratio"], 4),
            "io_wait_p50_ms": pcap["io_wait_p50_ms"],
            "io_wait_p99_ms": pcap["io_wait_p99_ms"],
            "precompile_wall_ms": pcap["precompile_wall_ms"],
        }
    except Exception as e:               # telemetry must never sink the
        out["pipeline"] = {"error": str(e)}   # headline capture

    if old is not None:
        out["compare"] = compare_models(old, models)
        out["compare_against"] = args.compare
    print(json.dumps(out))
    if args.compare:
        verdicts = [v["verdict"] for v in out["compare"].values()]
        if "regression" in verdicts:
            raise SystemExit(1)
        if "suspect" in verdicts:
            # distinct exit code: an untrustworthy capture (a stalled
            # window on either side) must not pass the regression gate
            # as if it were a clean sweep. 3, not 2 — argparse owns
            # exit 2 for usage/corrupt-record errors, and a CI gate must
            # be able to tell "re-run the sweep" from "fix the record"
            raise SystemExit(3)


if __name__ == "__main__":
    main()
