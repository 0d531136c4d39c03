"""The command line: config-driven tasks (counterpart of
``cxxnet_tpu/main.py``).

A config file plus ``key=value`` CLI overrides drives the tasks
``train`` / ``pred`` / ``pred_raw`` / ``extract`` (``extract_feature``)
/ ``get_weight`` / ``serve`` / ``quantize``, and ``test_io = 1`` runs
the data pipeline without the net. Snapshots are written as
``<model_dir>/<round:04d>.model.npz``, synchronously; a ``model_in``
named that way sets the round a train run starts from. The printed
lines keep the reference's format (``[r]\\ttrain-error:...``, the
``round %8d:[%8d]`` progress line, ``updating end, ...``).

``dev`` unset, or naming an accelerator (``gpu``, ``cuda``, ``tpu``),
runs on the GPU and raises when there is none; ``dev = cpu`` runs on
the CPU.

What this port does not have yet raises
:class:`~cxxnet_tpu_torch.utils.config.NotPortedError` naming its
``ROADMAP.md`` item: the tasks ``finetune``, ``export``,
``build_index``, ``serve_fleet``, ``fleet``, ``fleet_balancer`` and
``continual``; the keys ``continue = 1``, ``keep_snapshots > 0``,
``checkpoint_async = 1``, ``checkpoint_fsync = 0``, ``stream_retry >
0``, a remote ``model_dir``, ``precompile = 1``, ``test_on_server = 1``, ``monitor =
stdout|jsonl``, ``monitor_trace_dir`` and every ``dist_*`` key; and a
SIGTERM during training, which ends the run through that error in
place of the reference's emergency snapshot.

Usage: python -m cxxnet_tpu_torch.main config.conf [key=value ...]
"""

from __future__ import annotations

import os
import re
import signal
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .device import resolve_device
from .io import create_iterator
from .io.data import DataBatch, batch_mask
from .nnet.checkpoint import write_snapshot
from .nnet.trainer import NetTrainer
from .utils.config import (NotPortedError, Roadmap, parse_cli_overrides,
                           parse_config_file, split_sections)
from .utils.stream import open_stream, uri_scheme

_MODEL_RE = re.compile(r"^(\d{4})\.model\.npz$")

# tasks that read data through the pred iterator (or its fallback);
# quantize rides here too — calibration wants the deterministic eval
# transform, not the shuffled/augmented training stream
_PRED_TASKS = ("pred", "extract_feature", "extract", "pred_raw", "serve",
               "quantize", "build_index")

# randomized-pipeline knobs neutralized when a pred-like task falls
# back to the train data block: evaluation order must be the file
# order and every example must go through the deterministic eval
# transform (center crop / mean / scale stay — they define the input
# distribution; the stochastic knobs do not)
_PRED_NEUTRAL = (
    ("shuffle", "0"), ("shuffle_chunk", "0"),
    ("rand_crop", "0"), ("rand_mirror", "0"),
    ("max_random_contrast", "0"), ("max_random_illumination", "0"),
    ("max_rotate_angle", "0"), ("max_shear_ratio", "0"),
    ("max_aspect_ratio", "0"),
    ("min_random_scale", "1"), ("max_random_scale", "1"),
    ("min_crop_size", "-1"), ("max_crop_size", "-1"),
    ("rotate", "-1"), ("rotate_list", ""),
)

# tasks of the reference this port does not have yet, by ROADMAP item
NOT_PORTED_TASKS: Dict[str, str] = {
    "finetune": Roadmap.CHECKPOINT_CLI,
    "export": Roadmap.BUNDLES,
    "build_index": Roadmap.RETRIEVAL,
    "serve_fleet": Roadmap.FLEET,
    "fleet": Roadmap.FLEET,
    "fleet_balancer": Roadmap.FLEET,
    "continual": Roadmap.FLEET,
}


def _not_ported_key(name: str, val: str) -> Optional[str]:
    """The ROADMAP item of a global key whose value asks for what this
    port does not have yet, or None."""
    if name.startswith("dist_"):
        return Roadmap.MULTI_GPU
    if name == "model_dir" and uri_scheme(val):
        return Roadmap.CHECKPOINT_CLI
    if name == "test_on_server" and int(val):
        return Roadmap.MULTI_GPU
    if name in ("monitor", "monitor_trace_dir") \
            and val not in ("", "none"):
        return Roadmap.TELEMETRY
    if (name in ("continue", "keep_snapshots", "stream_retry",
                 "precompile", "checkpoint_async") and int(val)) \
            or (name == "checkpoint_fsync" and not int(val)):
        return Roadmap.CHECKPOINT_CLI
    return None


def _warn_once(seen: set, code: str, message: str) -> None:
    """One stderr line per warning code and run."""
    if code not in seen:
        seen.add(code)
        sys.stderr.write("[cxxnet_tpu_torch] warning %s: %s\n"
                         % (code, message))


class LearnTask:
    def __init__(self) -> None:
        self.task = "train"
        self.num_round = 10
        self.start_counter = 1
        self.save_period = 1
        self.model_dir = "./models"
        self.model_in = ""
        self.print_step = 100
        self.silent = 0
        self.task_eval_train = 1
        self.name_pred = "pred.txt"
        self.output_format = "txt"
        self.extract_node_name = ""
        self.weight_filename = "weight.txt"
        self.weight_layer = ""
        self.weight_tag = "wmat"
        self.test_io = 0
        self.device = ""
        # batches per update_many window in the train loop; the round's
        # tail goes through per-batch update
        self.dispatch_period = 8
        # post-training quantization (task = quantize): target dtype,
        # calibration stream length, the f32 parity gate, output path
        self.quantize_dtype = "int8"
        self.quantize_batches = 8
        self.quantize_parity_eps = 0.05
        self.quantize_out = ""
        self._warned: set = set()

    # -- config ----------------------------------------------------------

    def _set(self, name: str, val: str) -> None:
        item = _not_ported_key(name, val)
        if item is not None:
            raise NotPortedError("%s = %s" % (name, val), item)
        if name == "task":
            self.task = val
        if name in ("num_round", "max_round"):
            self.num_round = int(val)
        if name == "start_counter":
            self.start_counter = int(val)
        if name == "save_model":
            self.save_period = 0 if val == "0" else int(val)
        if name == "model_dir":
            self.model_dir = val
        if name == "model_in":
            self.model_in = val
        if name == "print_step":
            self.print_step = int(val)
        if name == "silent":
            self.silent = int(val)
        if name in ("eval_train", "train_eval"):
            self.task_eval_train = int(val)
        if name == "extract_node_name":
            self.extract_node_name = val
        if name == "extract_layer_name":
            # the get_weight layer selector, NOT an extract_feature
            # trigger
            self.weight_layer = val
        if name == "output_format":
            if val not in ("txt", "bin"):
                raise ValueError(
                    "output_format must be 'txt' or 'bin', got %r" % val)
            self.output_format = val
        if name == "weight_filename":
            self.weight_filename = val
        if name == "weight_layer":
            self.weight_layer = val
        if name == "weight_tag":
            self.weight_tag = val
        if name == "test_io":
            self.test_io = int(val)
        if name == "dev":
            self.device = val
        if name == "dispatch_period":
            self.dispatch_period = max(1, int(val))
        if name == "quantize_dtype":
            self.quantize_dtype = val
        if name == "quantize_batches":
            self.quantize_batches = int(val)
        if name == "quantize_parity_eps":
            self.quantize_parity_eps = float(val)
        if name == "quantize_out":
            self.quantize_out = val

    def _torch_device(self) -> str:
        """``dev = cpu`` runs on the CPU; unset or any accelerator name
        on the GPU."""
        return "cpu" if self.device.split(":")[0] == "cpu" else "cuda"

    # -- model files -----------------------------------------------------

    def _model_path(self, counter: int) -> str:
        return os.path.join(self.model_dir, "%04d.model.npz" % counter)

    # -- run -------------------------------------------------------------

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            print("Usage: python -m cxxnet_tpu_torch.main config.conf "
                  "[key=value ...]")
            return 1
        for env in ("CXXNET_COORDINATOR", "CXXNET_NUM_CPU_DEVICES"):
            if os.environ.get(env):
                raise NotPortedError("the %s launch" % env,
                                     Roadmap.MULTI_GPU)
        cfg = parse_config_file(argv[0])
        cfg += parse_cli_overrides(argv[1:])
        blocks, global_cfg = split_sections(cfg)
        for name, val in global_cfg:
            self._set(name, val)
        if self.task in NOT_PORTED_TASKS:
            raise NotPortedError("task = %s" % self.task,
                                 NOT_PORTED_TASKS[self.task])
        # 'pred = <outfile>' doubles as the pred-block marker, so read
        # it from the raw stream
        for name, val in cfg:
            if name == "pred":
                self.name_pred = val
        # the device first: no GPU and no dev = cpu raises before any
        # file is read
        dev = resolve_device(self._torch_device())

        # iterators (closed on exit: prefetch threads / decode pools);
        # hoisted above the try so the finally can always iterate it
        all_iters: List[object] = []
        try:
            # model_in via filename convention infers the start counter
            if self.model_in and self.task == "train":
                m = _MODEL_RE.match(os.path.basename(self.model_in))
                if m:
                    self.start_counter = int(m.group(1)) + 1

            itr_train = None
            eval_iters: List[Tuple[str, object]] = []
            pred_iter = None
            batch_cfg = [(k, v) for k, v in global_cfg
                         if k in ("batch_size", "input_shape", "label_width")]
            if (self.task in _PRED_TASKS and not self.test_io
                    and not any(b["kind"] == "pred" for b in blocks)):
                # no 'pred =' block: these tasks fall back to the train
                # data block, which is configured for training (shuffled,
                # randomly augmented) — say so once, and neutralize the
                # stochastic knobs so the output is deterministic and
                # row-aligned with the source files
                for b in blocks:
                    if b["kind"] != "data":
                        continue
                    b["cfg"] = list(b["cfg"]) + list(_PRED_NEUTRAL)
                    _warn_once(
                        self._warned, "pred_fallback_train_iter",
                        "task=%s has no 'pred =' iterator block; "
                        "falling back to the train data block %r with "
                        "shuffle/augmentation disabled" %
                        (self.task, b["name"]))
            for b in blocks:
                it = create_iterator(b["cfg"], batch_cfg)
                all_iters.append(it)
                it.init()
                if b["kind"] == "data":
                    itr_train = it
                elif b["kind"] == "eval":
                    eval_iters.append((b["name"], it))
                elif b["kind"] == "pred":
                    pred_iter = it

            if self.test_io:
                return self._task_test_io(itr_train)

            if self.task == "serve":
                assert self.model_in, "task serve requires model_in"
                return self._task_serve(cfg, pred_iter or itr_train, dev)

            if self.task == "quantize":
                assert self.model_in, "task quantize requires model_in"
                return self._task_quantize(cfg, pred_iter or itr_train,
                                           dev)

            trainer = NetTrainer(cfg, device=dev)
            if self.task == "train":
                if self.model_in:
                    trainer.load_model(self.model_in)
                else:
                    trainer.init_model()
                return self._task_train(trainer, itr_train, eval_iters)

            assert self.model_in, "task %s requires model_in" % self.task
            trainer.load_model(self.model_in)
            if self.task == "pred":
                return self._task_predict(trainer, pred_iter or itr_train)
            if self.task in ("extract_feature", "extract", "pred_raw"):
                # "pred_raw" is a raw probability dump = extract of the
                # top node
                if self.task == "pred_raw" and \
                        not self.extract_node_name:
                    self.extract_node_name = "top"
                return self._task_extract(trainer, pred_iter or itr_train)
            if self.task == "get_weight":
                return self._task_get_weight(trainer)
            print("unknown task %r" % self.task)
            return 1
        finally:
            # iterator construction and the task bodies share one
            # cleanup scope: a config error must still close prefetch
            # threads and decode pools
            for it in all_iters:
                it.close()

    def _task_test_io(self, itr) -> int:
        assert itr is not None, "test_io requires a data block"
        start = time.time()
        n = 0
        for r in range(self.num_round):
            for batch in itr:
                n += batch.batch_size - batch.num_batch_padd
        dt = time.time() - start
        print("test_io: %d instances in %.2fs (%.1f/sec)"
              % (n, dt, n / max(dt, 1e-9)))
        return 0

    # -- train -----------------------------------------------------------

    @staticmethod
    def _on_sigterm(signum, frame):
        raise NotPortedError("the SIGTERM emergency snapshot",
                             Roadmap.CHECKPOINT_CLI)

    def _task_train(self, trainer, itr_train, eval_iters) -> int:
        assert itr_train is not None, "train requires a data block"
        # batches reach update() as host arrays and are copied there,
        # synchronously from pageable memory, so no ring buffer is
        # handed back while a copy still reads it (staging in the
        # prefetch thread is the image data pipeline item)
        k = self.dispatch_period
        start = time.time()

        def _progress(r, nbatch):
            if (self.print_step and nbatch % self.print_step < k
                    and self.silent == 0):
                print("round %8d:[%8d] %ld sec elapsed"
                      % (r, nbatch, int(time.time() - start)))

        # a SIGTERM raises (no emergency snapshot yet); only the main
        # thread can own signal handlers
        old_handler = None
        if threading.current_thread() is threading.main_thread():
            old_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        try:
            for r in range(self.start_counter - 1, self.num_round):
                trainer.start_round(r)
                nbatch = 0
                window = []
                for batch in itr_train:
                    if k == 1:
                        trainer.update(batch)
                        nbatch += 1
                    else:
                        window.append(batch)
                        if len(window) < k:
                            continue
                        trainer.update_many(window)
                        nbatch += len(window)
                        window = []
                    _progress(r, nbatch)
                for batch in window:    # round tail: per-batch
                    trainer.update(batch)
                    nbatch += 1
                trainer.end_round()     # close the throughput window
                #                         before evals start
                line = "[%d]" % (r + 1)
                if self.task_eval_train:
                    line += trainer.train_metric_str("train")
                for name, it in eval_iters:
                    line += trainer.evaluate(it, name)
                if self.silent == 0:
                    print(line)
                if self.save_period and (r + 1) % self.save_period == 0:
                    trainer.save_model(self._model_path(r + 1))
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
        if self.silent == 0:
            print("updating end, %ld sec in all"
                  % int(time.time() - start))
        return 0

    # -- serve and quantize ----------------------------------------------

    def _task_serve(self, cfg, itr, dev) -> int:
        """Long-lived concurrent predictor: load the snapshot into a
        frozen bucketed engine behind the dynamic batcher, then drive
        ``serve_clients`` threaded closed-loop clients over the
        iterator's examples."""
        assert itr is not None, "serve requires an iterator block"
        from .serve import ServeSession, run_closed_loop
        sess = ServeSession(cfg, model_path=self.model_in, device=dev)
        try:
            c = sess.cfg
            # example pool for the clients: enough valid rows that
            # wrapping reuse stays fair, forced to a private float32
            # copy (iterator ring buffers recycle their arrays)
            want = max(256, c.clients * c.request_rows)
            pool_parts, got = [], 0
            for batch in itr:
                n = batch.batch_size - batch.num_batch_padd
                pool_parts.append(np.array(batch.data[:n], np.float32))
                got += n
                if got >= want:
                    break
            assert pool_parts, "serve: iterator produced no examples"
            pool = np.concatenate(pool_parts, axis=0)
            agg = run_closed_loop(sess, pool, c.clients, c.requests,
                                  c.request_rows)
            summary = sess.close()
        finally:
            # a failure between warmup and close must not leave the
            # worker threads running (close is idempotent)
            sess.close(drain=False)
        print("serve: %d ok / %d busy / %d timeout / %d error requests "
              "(%d rows) in %.2fs, p50 %.1f ms p99 %.1f ms, fill %.2f, "
              "compiles after warmup %d"
              % (agg["ok"], agg["busy"], agg["timeout"], agg["error"],
                 summary["rows"], agg["wall_s"],
                 summary["latency_p50_ms"], summary["latency_p99_ms"],
                 summary["fill_rate"], summary["compile_events"]))
        return 0

    def _task_quantize(self, cfg, itr, dev) -> int:
        """Post-training calibration: stream the iterator through the
        frozen eval net collecting per-channel ranges, parity-gate the
        quantized graph against the f32 eval outputs over the same
        batches, and commit a snapshot whose ``quant/`` arrays carry the
        ranges (what ``serve_dtype = int8`` loads)."""
        assert itr is not None, "quantize requires an iterator block"
        from .nnet.quantize import Calibrator, normalize_serve_dtype
        qdtype = normalize_serve_dtype(self.quantize_dtype)
        if qdtype not in ("int8", "fp8"):
            raise ValueError(
                "quantize_dtype must be int8 or fp8, got %r"
                % self.quantize_dtype)
        # calibration runs the f32 graph whatever the config's
        # serve_dtype says (the override appends last, so it wins)
        trainer = NetTrainer(list(cfg) + [("serve_dtype", "float32")],
                             device=dev)
        trainer.load_model(self.model_in)
        top = (trainer.graph.num_nodes - 1,)

        def rows(nb):
            (val,) = trainer.pred(trainer.to_device_batch(nb.data), top,
                                  batch_mask(nb))
            nvalid = nb.batch_size - nb.num_batch_padd
            out = val[:nvalid].cpu().numpy()
            return out.reshape(out.shape[0], -1)

        calib = Calibrator(trainer)
        if not calib.targets:
            raise ValueError(
                "task=quantize: this net has no quantizable layers "
                "(conv/fullc owning their params) — nothing to calibrate")
        batches, refs = [], []
        for batch in itr:
            # private copies: iterator ring buffers recycle their arrays
            nb = DataBatch(data=np.array(batch.data),
                           label=np.array(batch.label),
                           num_batch_padd=batch.num_batch_padd)
            refs.append(rows(nb))
            calib.observe(nb)
            batches.append(nb)
            if len(batches) >= self.quantize_batches:
                break
        assert batches, "quantize: iterator produced no batches"
        tables = calib.finish()
        qmeta = {"dtype": qdtype, "batches": len(batches),
                 "source": self.model_in,
                 "bn_fold_eval": trainer.net.bn_fold_eval,
                 "parity_eps": self.quantize_parity_eps}
        # activate the quantized graph on THIS trainer and measure
        # parity against the stored f32 outputs
        trainer.set_quantization(tables, qmeta, dtype=qdtype)
        max_abs = mean_sum = agree = nrow = nelt = 0
        for nb, ref in zip(batches, refs):
            got = rows(nb)
            diff = np.abs(got.astype(np.float64) - ref)
            max_abs = max(max_abs, float(diff.max()))
            mean_sum += float(diff.sum())
            nelt += diff.size
            agree += int(np.sum(trainer.rows_to_prediction(got)
                                == trainer.rows_to_prediction(ref)))
            nrow += got.shape[0]
        mean_abs = mean_sum / max(nelt, 1)
        agree_rate = agree / max(nrow, 1)
        rep = trainer.quant_report
        out = self.quantize_out or re.sub(
            r"\.npz$", "", self.model_in) + ".%s.npz" % qdtype
        ok = mean_abs <= self.quantize_parity_eps
        if ok:
            arrays, meta = trainer.gather_snapshot()
            write_snapshot(out, arrays, meta)
        print("quantize[%s]: %d layers (%d fallback) over %d batches, "
              "parity mean|Δ| %.2g max|Δ| %.2g agree %.3f — %s"
              % (rep.get("dtype", qdtype), rep.get("layers", 0),
                 rep.get("fallback_layers", 0), len(batches), mean_abs,
                 max_abs, agree_rate,
                 ("wrote %s" % out) if ok else
                 "PARITY GATE FAILED (eps %g), no snapshot written"
                 % self.quantize_parity_eps))
        return 0 if ok else 1

    # -- pred, extract, get_weight ---------------------------------------

    def _task_predict(self, trainer, itr) -> int:
        assert itr is not None, "pred requires an iterator"
        with open_stream(self.name_pred, "w") as f:
            for batch in itr:
                for v in trainer.predict(batch):
                    f.write("%g\n" % v)
        print("finished prediction, write into %s" % self.name_pred)
        return 0

    def _task_extract(self, trainer, itr) -> int:
        assert itr is not None, "extract requires an iterator"
        node = self.extract_node_name
        txt = self.output_format == "txt"
        nrow, shape3 = 0, (0, 0, 0)
        with open_stream(self.name_pred, "w" if txt else "wb") as f:
            for batch in itr:
                feats = trainer.extract_feature(batch, node)
                if feats.ndim == 4:      # NHWC -> (ch, y, x)
                    feats = feats.transpose(0, 3, 1, 2)
                    shape3 = feats.shape[1:]
                else:
                    feats = feats.reshape(feats.shape[0], -1)
                    shape3 = (1, 1, feats.shape[1])
                nrow += feats.shape[0]
                if txt:
                    flat = feats.reshape(feats.shape[0], -1)
                    for row in flat:
                        f.write(" ".join("%g" % x for x in row) + "\n")
                else:
                    f.write(np.ascontiguousarray(
                        feats, dtype="<f4").tobytes())
        # shape sidecar: "nrow,ch,y,x"
        with open_stream(self.name_pred + ".meta", "w") as fm:
            fm.write("%d,%d,%d,%d\n" % ((nrow,) + tuple(shape3)))
        print("finished feature extraction, write into %s"
              % self.name_pred)
        return 0

    def _task_get_weight(self, trainer) -> int:
        assert self.weight_layer, "get_weight requires weight_layer"
        w = trainer.get_weight(self.weight_layer, self.weight_tag)
        rows = w.reshape(w.shape[0], -1) if w.ndim > 1 else w[None, :]
        if self.output_format == "txt":
            with open_stream(self.weight_filename, "w") as f:
                np.savetxt(f, rows, fmt="%g")
        else:                            # raw float32
            with open_stream(self.weight_filename, "wb") as f:
                f.write(np.ascontiguousarray(rows, "<f4").tobytes())
        print("weight %s:%s %s written to %s"
              % (self.weight_layer, self.weight_tag, w.shape,
                 self.weight_filename))
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    return LearnTask().run(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
