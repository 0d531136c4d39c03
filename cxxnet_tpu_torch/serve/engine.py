"""The frozen inference engine: a snapshot turned into a predictor
(counterpart of ``cxxnet_tpu/serve/engine.py``).

Wraps an eval-mode :class:`~cxxnet_tpu_torch.nnet.trainer.NetTrainer`
whose weights never change again. ``warmup()`` freezes the serve
weights and runs one zero batch through every batch-size bucket, so the
first request at a bucket pays no first-use cost (cuDNN execution-plan
choice, allocator growth). PyTorch keeps cuDNN handles and plans per
thread: warm up on the thread that will dispatch (``ServeSession`` runs
it on the batcher's dispatch thread).

Two-phase dispatch for the batcher's pipelined hand-off:

- :meth:`stage` — assemble rows into a pinned host buffer of the
  bucket's size and issue the host-to-device copy on a copy stream;
- :meth:`dispatch` — make the compute stream wait for that copy, run
  the forward and fetch the valid rows.

On the GPU each bucket keeps a small ring of pinned staging buffers; a
buffer is overwritten only after the CUDA event recorded behind its
previous copy has completed. On the CPU the "copy" would alias the host
buffer, so every stage takes a fresh one.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..io.data import inst_array_shape
from ..nnet.quantize import normalize_serve_dtype
from ..nnet.trainer import NetTrainer
from ..utils.config import NotPortedError, Roadmap
from ..utils.stream import local_path
from .bucketing import parse_buckets, pick_bucket

# staging ring depth per bucket: covers every concurrently in-flight
# staged batch of the batcher pipeline (stage_depth staged + one
# dispatching + one being staged); reuse also waits for the slot's
# previous copy, so the depth is a throughput knob, not a correctness
# bound
STAGE_RING_DEPTH = 4


def input_dtype_for(serve_dtype: str) -> torch.dtype:
    """The dtype a ladder stages its rows in for a ``serve_dtype``:
    bfloat16 stages bf16 (half the host-to-device bytes); int8 graphs
    quantize on the device, so their input stays float32."""
    return torch.bfloat16 if serve_dtype == "bfloat16" else torch.float32


class _StageSlot:
    """One pinned host staging buffer: the rows written since the last
    zeroing (``high``) and the event behind its last copy."""

    __slots__ = ("host", "high", "ready", "busy")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.high = 0
        self.ready: Optional[torch.cuda.Event] = None
        self.busy = True                 # created for its first caller


class StagedBatch:
    """A micro-batch whose host-to-device copy has been issued: the
    device tensor, the event that marks the copy done (GPU), the
    valid-row count and the node set to fetch."""

    __slots__ = ("data", "ready", "nvalid", "bucket", "nodes")

    def __init__(self, data: torch.Tensor,
                 ready: Optional[torch.cuda.Event], nvalid: int,
                 bucket: int, nodes: Tuple[int, ...]):
        self.data = data
        self.ready = ready
        self.nvalid = nvalid
        self.bucket = bucket
        self.nodes = nodes


class InferenceEngine:
    """Bucketed predictor over a loaded trainer.

    Thread safety: :meth:`dispatch` (and the one-shot helpers) issue
    the forward under an internal lock — one at a time, callers from
    any thread; the device-to-host fetch of the result runs outside it.
    """

    def __init__(self, trainer: NetTrainer,
                 buckets: Optional[Sequence[int]] = None,
                 node: str = "", input_dtype: torch.dtype = torch.float32):
        assert trainer._initialized, \
            "InferenceEngine needs an initialized trainer"
        self.trainer = trainer
        # rows are cast to this dtype as they are copied into staging
        self.input_dtype = input_dtype
        self.device = trainer.device
        if buckets is None:
            buckets = parse_buckets("auto", trainer.batch_size)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_batch = self.buckets[-1]
        top = trainer.graph.num_nodes - 1
        self.nodes = (trainer.net.node_index_by_name(node) if node
                      else top,)
        self._lock = threading.Lock()
        self._warm: set = set()          # buckets warmup ran
        self._cold: set = set()          # buckets first run by traffic
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self._cuda else None
        self._stage_lock = threading.Lock()
        self._ring: Dict[int, List[_StageSlot]] = {}
        self._ring_next: Dict[int, int] = {}
        self.counters: Dict[str, int] = {
            "dispatches": 0, "rows": 0, "pad_rows": 0, "aot_hits": 0,
            "compile_events": 0, "staging_reuse": 0, "staging_alloc": 0,
            "d2h_bytes": 0}

    # -- warmup ----------------------------------------------------------

    def warmup(self, warm_run: bool = True) -> int:
        """Freeze the serve weights and, with ``warm_run``, push one
        zero batch through each bucket. Returns the number of buckets
        run. Resets the counters: afterwards ``aot_hits`` counts
        dispatches at a warmed bucket and ``compile_events`` first
        dispatches at a bucket warmup did not run. Under the trainer's
        monitor each bucket run emits a ``compile`` record (kind
        "precompile": its first-use wall) and the warmup a
        ``precompile`` record."""
        t_start = time.perf_counter()
        t = self.trainer
        mon = t._mon if t._mon_on() else None
        t.freeze_serve_weights()
        if warm_run:
            inst = self._inst_shape()
            for b in self.buckets:
                t0 = time.perf_counter()
                self.dispatch(self.stage(np.zeros((b,) + inst, np.float32)))
                self._warm.add(b)
                if mon is not None:
                    mon.emit("compile", kind="precompile",
                             wall_ms=(time.perf_counter() - t0) * 1e3,
                             signature=repr(("pred", (b,) + inst)))
        if mon is not None:
            mon.emit("precompile",
                     wall_ms=(time.perf_counter() - t_start) * 1e3,
                     programs=len(self._warm))
        with self._lock, self._stage_lock:
            for k in self.counters:
                self.counters[k] = 0
        return len(self._warm)

    def _inst_shape(self) -> Tuple[int, ...]:
        return inst_array_shape(tuple(self.trainer.graph.input_shape))

    # -- two-phase dispatch (the batcher path) ---------------------------

    def stage(self, rows: Union[np.ndarray, Sequence[np.ndarray]]
              ) -> StagedBatch:
        """Assemble ``rows`` (one array, or the batcher's list of
        per-request row arrays) into a staging buffer of the bucket's
        size, zero the pad tail, and issue the host-to-device copy.
        Request rows copy once, straight into the buffer, cast to the
        warmed ``input_dtype`` during the copy."""
        if isinstance(rows, (list, tuple)):
            parts = [np.asarray(r) for r in rows]
        else:
            parts = [np.asarray(rows)]
        inst = self._inst_shape()
        for p in parts:
            # the copy below would silently broadcast a mis-shaped row
            if tuple(p.shape[1:]) != inst:
                raise ValueError(
                    "request row shape %r does not match the served "
                    "instance shape %r" % (p.shape[1:], inst))
        n = sum(p.shape[0] for p in parts)
        bucket = pick_bucket(n, self.buckets)
        if bucket is None:
            raise ValueError(
                "batch of %d rows exceeds the largest bucket %d"
                % (n, self.max_batch))
        slot = self._acquire_slot(bucket, n)
        try:
            host = slot.host if slot is not None else torch.zeros(
                (bucket,) + inst, dtype=self.input_dtype)
            off = 0
            for p in parts:
                # casts during the copy (to bf16: round to nearest even)
                host[off:off + p.shape[0]].copy_(torch.from_numpy(
                    np.ascontiguousarray(p)))
                off += p.shape[0]
            ready = None
            if self._cuda:
                with torch.cuda.stream(self._copy_stream):
                    data = host.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
            else:
                data = host
        except BaseException:
            # a failed stage hands its slot back, or transient errors
            # would retire the whole ring
            if slot is not None:
                slot.busy = False
            raise
        if slot is not None:
            slot.ready = ready
            slot.busy = False
        return StagedBatch(data, ready, n, bucket, self.nodes)

    def _acquire_slot(self, bucket: int,
                      n: int) -> Optional[_StageSlot]:
        """A ring slot for ``bucket`` that is safe to overwrite, or None
        for a transient buffer (CPU, or every slot in use)."""
        with self._stage_lock:
            if not self._cuda:
                self.counters["staging_alloc"] += 1
                return None
            ring = self._ring.setdefault(bucket, [])
            slot = None
            start = self._ring_next.get(bucket, 0)
            for k in range(len(ring)):           # oldest-first scan
                cand = ring[(start + k) % len(ring)]
                if not cand.busy:
                    slot = cand
                    self._ring_next[bucket] = (start + k + 1) % len(ring)
                    self.counters["staging_reuse"] += 1
                    break
            if slot is None:
                if len(ring) >= STAGE_RING_DEPTH:
                    self.counters["staging_alloc"] += 1
                    return None
                host = torch.zeros((bucket,) + self._inst_shape(),
                                   dtype=self.input_dtype,
                                   pin_memory=True)
                slot = _StageSlot(host)
                ring.append(slot)
                self.counters["staging_alloc"] += 1
            slot.busy = True
        if slot.ready is not None:
            # the slot's previous copy must finish before its buffer is
            # overwritten (almost always done: the slot is
            # STAGE_RING_DEPTH batches old)
            slot.ready.synchronize()
            slot.ready = None
        if slot.high > n:
            slot.host[n:slot.high].zero_()   # zero the pad tail once
        slot.high = n
        return slot

    def dispatch(self, staged: StagedBatch) -> np.ndarray:
        """Run the staged batch and return the valid rows of the
        requested node as float32 numpy (natural node shape)."""
        t = self.trainer
        with self._lock:
            if staged.bucket in self._warm:
                self.counters["aot_hits"] += 1
            elif staged.bucket not in self._cold:
                self._cold.add(staged.bucket)
                self.counters["compile_events"] += 1
            if staged.ready is not None:
                # the forward runs on this thread's current stream: it
                # waits for the staged copy, and the allocator must not
                # recycle the copy-stream tensor before it is consumed
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(staged.ready)
                staged.data.record_stream(cur)
            vals = t.pred(staged.data, staged.nodes)
        # the result fetch waits for the device: outside the lock, so
        # concurrent callers do not convoy behind one round trip
        out_dev = vals[0]
        if staged.nvalid < staged.bucket:
            out_dev = out_dev[:staged.nvalid]   # only valid rows cross
        out = out_dev.cpu().numpy()
        with self._lock:
            self.counters["dispatches"] += 1
            self.counters["rows"] += staged.nvalid
            self.counters["pad_rows"] += staged.bucket - staged.nvalid
            self.counters["d2h_bytes"] += int(out.nbytes)
        return out

    # -- one-shot helpers (library path) ---------------------------------

    def run(self, rows: np.ndarray) -> np.ndarray:
        """Score ``rows`` of any count: chunks of ``max_batch`` rows
        dispatch bucket-padded, results concatenate back."""
        rows = np.asarray(rows)
        if rows.shape[0] < 1:
            raise ValueError("run() needs at least one row")
        outs = []
        for i in range(0, rows.shape[0], self.max_batch):
            outs.append(self.dispatch(self.stage(
                rows[i:i + self.max_batch])))
        return np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]

    def predict(self, rows: np.ndarray) -> np.ndarray:
        """Per-row predicted class index (or raw scalar) of the top
        node."""
        return self.trainer.rows_to_prediction(self.run(rows))

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock, self._stage_lock:
            return dict(self.counters)


def build_engine(cfg, model_path: str,
                 buckets: Optional[Union[str, Sequence[int]]] = None,
                 max_batch: int = 0, node: str = "",
                 device=None, monitor=None) -> InferenceEngine:
    """Load a snapshot into a frozen engine on ``device`` (the GPU by
    default). ``cfg`` is the ordered config-pair stream (netconfig +
    globals, ``serve_dtype`` among them); ``buckets`` a ladder or a
    ``serve_buckets`` spec; ``monitor`` gets the trainer's records
    (attached before the load)."""
    cfg = list(cfg)
    if os.path.isdir(local_path(model_path)):
        raise NotPortedError("a bundle as model_path (%r)" % model_path,
                             Roadmap.BUNDLES)
    serve_dtype = "float32"
    for k, v in cfg:
        if k == "serve_dtype":
            serve_dtype = normalize_serve_dtype(v)
    if not max_batch:
        for k, v in cfg:
            if k == "batch_size":
                max_batch = int(v)
    if not max_batch:
        raise ValueError("serve needs batch_size (or serve_max_batch)")
    if isinstance(buckets, str) or buckets is None:
        buckets = parse_buckets(buckets or "", max_batch)
    trainer = NetTrainer(cfg, device=device)
    trainer.set_monitor(monitor)
    trainer.load_model(model_path)
    return InferenceEngine(trainer, buckets=buckets, node=node,
                           input_dtype=input_dtype_for(serve_dtype))
