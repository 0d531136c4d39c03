"""The command line: config-driven tasks (counterpart of
``cxxnet_tpu/main.py``).

A config file plus ``key=value`` CLI overrides drives the tasks
``train`` / ``finetune`` / ``pred`` / ``pred_raw`` / ``extract``
(``extract_feature``) / ``get_weight`` / ``serve`` / ``serve_fleet`` /
``quantize`` / ``export`` / ``continual`` / ``fleet`` /
``fleet_balancer``, and ``test_io = 1`` runs the data pipeline without
the net. ``serve_fleet`` serves HTTP/JSON and the
CXN1/CXN2 binary protocols (``serve/frontend.py``) for
``serve_fleet_duration_s`` seconds, or until SIGTERM or SIGINT when it
is 0, then drains. ``export`` seals ``model_in`` into a bundle at
``export_out`` (default: ``NNNN.model.bundle`` beside it;
``artifact/bundle.py``), and a bundle serves as ``model_in`` wherever a
snapshot does. ``continual`` trains while its fleet serves and
hot-swaps each gated generation's bundle in (``continual/loop.py``);
SIGTERM or SIGINT ends it with an emergency snapshot and exit 75.
``fleet`` runs the horizontal tier (``fleet/``): a balancer and an
autoscale controller (with an optional canary rollout and extra
``fleet_balancer`` doors) over ``task = serve_fleet`` replica processes
spawned from the same config file and CLI overrides, for
``fleet_duration_s`` seconds (0: until SIGTERM or SIGINT), then drains
them. ``fleet_balancer`` is one door of a sharded front tier, learning
replicas and peers from the endpoint registry. The printed
lines keep the reference's format (``[r]\\ttrain-error:...``, the
``round %8d:[%8d]`` progress line, ``updating end, ...``).

Checkpoints, as the reference keeps them:

- snapshots are ``<model_dir>/<round:04d>.model.npz`` (``model_dir`` may
  be a ``scheme://`` URI: ``utils/stream.py``), committed atomically
  with a content digest by ``nnet/checkpoint.py``'s
  ``CheckpointManager``: on a background writer under
  ``checkpoint_async = 1`` (the default; the training thread pays the
  device-to-host gather), inline under 0; ``checkpoint_fsync = 0``
  skips the fsyncs; ``keep_snapshots = K`` keeps the newest K; a
  failed commit warns and training goes on;
- ``continue = 1`` resumes from the newest snapshot that verifies,
  quarantining corrupt ones (``<name>.quarantined``); a ``model_in``
  named ``NNNN.model.npz`` sets the round a train run starts from;
- ``task = finetune`` initializes the configured net and carries the
  layers of ``model_in`` by name and shape; ``finetune_remap = a,b``
  keeps those layers fresh, and any other changed shape raises
  ``FinetuneShapeError`` unless ``finetune_strict = 0``; a resumed
  finetune loads its own snapshot;
- SIGTERM or SIGINT during training sets a flag that the loop reads at
  every dispatch boundary and before each round: the run drains its
  writer, commits an emergency snapshot under the number of completed
  rounds, and exits with ``EXIT_PREEMPTED`` (75); ``continue = 1``
  then re-runs the interrupted round from its start with the mid-round
  weights;
- ``stream_retry = N`` retries transient remote reads; ``precompile =
  1`` builds the net's kernels and runs one step and one eval forward
  on a zero batch before round 0 (``NetTrainer.precompile``).

Telemetry (``monitor/``): ``monitor = stdout|jsonl`` (with
``monitor_path``, ``monitor_flush_period``, ``monitor_rotate_mb``) emits
the reference's records beside the printed lines, which stay the same
byte for byte: ``run_start``, ``round_start``, a ``step`` per dispatch
(``wall_ms`` to a device sync, ``data_wait_ms``), ``compile``,
``round_end``, ``memory``, ``io_wait``, ``pipeline``, ``eval``,
``checkpoint``, ``resume``, ``preempt``, ``run_end``; ``test_io`` and
``task_end`` for the other tasks. ``monitor_trace_dir`` (with
``monitor_trace_begin`` / ``monitor_trace_end``) writes a
``torch.profiler`` trace over a round window.

``dev`` unset, or naming an accelerator (``gpu``, ``cuda``, ``tpu``),
runs on the GPU and raises when there is none; ``dev = cpu`` runs on
the CPU. ``fleet`` and ``fleet_balancer`` resolve no device (they only
move bytes, and open no CUDA context); their replicas resolve ``dev``
themselves.

``task = build_index`` embeds the pred iterator's rows (at most
``index_rows``; 0 = all) through the frozen serve net at ``serve_node``
and seals the model and an :class:`~cxxnet_tpu_torch.retrieval.
EmbeddingIndex` (``index_metric = dot|cosine``; ``search_k``,
``search_buckets``) as one bundle at ``export_out``.

What this port does not have yet raises
:class:`~cxxnet_tpu_torch.utils.config.NotPortedError` naming its
``ROADMAP.md`` item: the keys ``test_on_server = 1`` and every
``dist_*`` key.

Usage: python -m cxxnet_tpu_torch.main config.conf [key=value ...]
"""

from __future__ import annotations

import os
import re
import signal
import sys
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .device import named_device, resolve_device
from .io import create_iterator
from .io.data import DataBatch, batch_mask
from .io.iter_batch import enable_chain_wait_stats, pipeline_snapshot
from .monitor import (Monitor, create_monitor, device_memory_snapshot,
                      reset_warnings, run_metadata, set_global)
from .nnet.checkpoint import (CheckpointManager, find_latest_valid,
                              write_snapshot)
from .nnet.trainer import NetTrainer
from .utils.config import (NotPortedError, Roadmap, parse_cli_overrides,
                           parse_config_file, split_sections)
from .utils.stream import open_stream, set_stream_retry, uri_scheme

_MODEL_RE = re.compile(r"^(\d{4})\.model\.npz$")

# exit code of a preempted run: SIGTERM/SIGINT arrived and the emergency
# snapshot committed. EX_TEMPFAIL: schedulers read it as "re-queue me"
EXIT_PREEMPTED = 75

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

# tasks whose process computes nothing (the fleet tier's controller and
# doors): no device is resolved for them
_TIER_TASKS = ("fleet", "fleet_balancer")


def _not_ported_key(name: str, val: str) -> Optional[str]:
    """The ROADMAP item of a global key whose value asks for what this
    port does not have yet, or None."""
    if name.startswith("dist_"):
        return Roadmap.MULTI_GPU
    if name == "test_on_server" and int(val):
        return Roadmap.MULTI_GPU
    return None


class LearnTask:
    def __init__(self) -> None:
        self.task = "train"
        self.num_round = 10
        self.start_counter = 1
        self.save_period = 1
        self.model_dir = "./models"
        self.model_in = ""
        self.continue_training = 0
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
        # precompile = 1: build the kernels and run the step once on a
        # zero batch before round 0 (NetTrainer.precompile)
        self.precompile = 0
        # checkpoints (nnet/checkpoint.py): a background commit thread,
        # durable fsync, retention, remote-read retries
        self.checkpoint_async = 1
        self.checkpoint_fsync = 1
        self.keep_snapshots = 0          # 0 = keep every snapshot
        self.stream_retry = 0
        # finetune: layers re-initialized fresh (the new head); any
        # other changed shape raises unless finetune_strict = 0
        self.finetune_remap: Tuple[str, ...] = ()
        self.finetune_strict = 1
        # task = export / build_index: the bundle's path ("" = beside
        # model_in)
        self.export_out = ""
        # task = build_index: a cap on the corpus rows (0 = the whole
        # iterator); the metric is ServeConfig's index_metric
        self.index_rows = 0
        self._resume_found = False
        # set by the SIGTERM/SIGINT handler; read at the train loop's
        # next dispatch boundary
        self._preempt_signum: Optional[int] = None
        # telemetry: a null monitor until run() builds the configured
        # one, so the task methods can be called directly
        self._mon = Monitor()
        self._cfg_stream: List[Tuple[str, str]] = []

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
        if name == "continue":
            self.continue_training = int(val)
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
        if name == "precompile":
            self.precompile = int(val)
        if name == "checkpoint_async":
            self.checkpoint_async = int(val)
        if name == "checkpoint_fsync":
            self.checkpoint_fsync = int(val)
        if name == "keep_snapshots":
            self.keep_snapshots = int(val)
        if name == "stream_retry":
            self.stream_retry = int(val)
        if name == "finetune_remap":
            self.finetune_remap = tuple(
                t.strip() for t in val.split(",") if t.strip())
        if name == "finetune_strict":
            self.finetune_strict = int(val)
        if name == "export_out":
            self.export_out = val
        if name == "index_rows":
            self.index_rows = int(val)

    def _torch_device(self) -> str:
        """``dev = cpu`` runs on the CPU; unset or any accelerator name
        on the GPU."""
        return named_device(self.device)

    # -- model files -----------------------------------------------------

    def _model_path(self, counter: int) -> str:
        if uri_scheme(self.model_dir):
            return "%s/%04d.model.npz" % (self.model_dir.rstrip("/"),
                                          counter)
        return os.path.join(self.model_dir, "%04d.model.npz" % counter)

    def _sync_latest_model(self) -> Optional[str]:
        """The newest snapshot of model_dir that verifies (local or
        remote); corrupt candidates are quarantined with a warning.
        Sets the round to start from; emits the ``resume`` record."""
        rep = find_latest_valid(self.model_dir)
        if rep.path is None and rep.quarantined:
            self._mon.warn_once(
                "resume_no_valid_snapshot",
                "continue=1: model_dir %r holds %d snapshot(s) but none "
                "verifies — quarantined %s and starting from round 0"
                % (self.model_dir, rep.scanned,
                   ", ".join(rep.quarantined)))
        if self._mon.enabled:
            self._mon.emit("resume", source=rep.path or "",
                           counter=-1 if rep.counter is None
                           else rep.counter,
                           scanned=rep.scanned,
                           quarantined=len(rep.quarantined))
        if rep.path is None:
            return None
        self.start_counter = rep.counter + 1
        return rep.path

    # -- run -------------------------------------------------------------

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            print("Usage: python -m cxxnet_tpu_torch.main config.conf "
                  "[key=value ...]")
            return 1
        reset_warnings()                 # each code warns once a run
        for env in ("CXXNET_COORDINATOR", "CXXNET_NUM_CPU_DEVICES"):
            if os.environ.get(env):
                raise NotPortedError("the %s launch" % env,
                                     Roadmap.MULTI_GPU)
        cfg = parse_config_file(argv[0])
        cfg += parse_cli_overrides(argv[1:])
        blocks, global_cfg = split_sections(cfg)
        for name, val in global_cfg:
            self._set(name, val)
        # 'pred = <outfile>' doubles as the pred-block marker, so read
        # it from the raw stream
        for name, val in cfg:
            if name == "pred":
                self.name_pred = val
        # the device first: no GPU and no dev = cpu raises before any
        # file is read. The tier's processes only move bytes and open
        # no CUDA context; their replicas resolve dev themselves
        dev = None if self.task in _TIER_TASKS \
            else resolve_device(self._torch_device())
        # opt-in retries of transient remote reads; 0 (the default)
        # fails fast
        set_stream_retry(self.stream_retry)
        # telemetry (monitor = none|stdout|jsonl), installed as the
        # global monitor so deep call sites (checkpoint writers, stream
        # retries, warnings) reach the same stream
        self._cfg_stream = cfg
        self._mon = create_monitor(global_cfg)
        set_global(self._mon)

        # iterators (closed on exit: prefetch threads / decode pools);
        # hoisted above the try so the finally can always iterate it
        all_iters: List[object] = []
        try:
            if self.task == "serve_fleet":
                # network traffic, not an iterator: no data block is
                # built (a deployment config's train blocks may point
                # at paths the serving host does not mount)
                return self._task_serve_fleet(cfg, dev)
            if self.task == "fleet":
                # balancer + autoscaler + canary over N replica
                # processes, each a task = serve_fleet child spawned
                # from this same config file and these CLI overrides
                return self._task_fleet(cfg, argv[0], argv[1:])
            if self.task == "fleet_balancer":
                # one door of a sharded front tier, learning replicas
                # and peers from the endpoint registry
                return self._task_fleet_balancer(cfg)
            if self.task == "export":
                # sealing needs the net config and the serve contract,
                # no data
                assert self.model_in, "task export requires model_in"
                return self._task_export(cfg, dev)
            # model_in via filename convention infers the start counter
            # (finetune starts a fresh numbering)
            if self.model_in and self.task == "train":
                m = _MODEL_RE.match(os.path.basename(self.model_in))
                if m:
                    self.start_counter = int(m.group(1)) + 1
            if self.continue_training:
                latest = self._sync_latest_model()
                self._resume_found = latest is not None
                if latest is not None:
                    self.model_in = latest

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
                    self._mon.warn_once(
                        "pred_fallback_train_iter",
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
                return self._task_test_io(itr_train, dev)

            if self.task == "serve":
                assert self.model_in, "task serve requires model_in"
                return self._task_serve(cfg, pred_iter or itr_train, dev)

            if self.task == "quantize":
                assert self.model_in, "task quantize requires model_in"
                return self._task_quantize(cfg, pred_iter or itr_train,
                                           dev)

            if self.task == "build_index":
                assert self.model_in, \
                    "task build_index requires model_in"
                return self._task_build_index(cfg, pred_iter or itr_train,
                                              dev)

            trainer = NetTrainer(cfg, device=dev)
            # the monitor before init or load: their model records (a
            # finetune's carry record, a bundle's artifact_load) are
            # emitted there
            trainer.set_monitor(self._mon)
            if self.task in ("train", "finetune", "continual"):
                mode = self.task
                if self.task == "continual":
                    # the loop's training mode (continual_task)
                    from .continual import ContinualConfig
                    mode = ContinualConfig(cfg).task
                if self.model_in and (mode == "train"
                                      or self._resume_found):
                    # a plain verified load, a resumed finetune too: its
                    # own snapshots carry the remapped structure, and a
                    # re-remap would re-initialize the trained head
                    trainer.load_model(self.model_in)
                else:
                    trainer.init_model()
                    if mode == "finetune":
                        assert self.model_in, "finetune requires model_in"
                        trainer.finetune_from(
                            self.model_in, remap=self.finetune_remap,
                            strict=bool(self.finetune_strict))
                if self.task == "continual":
                    return self._task_continual(cfg, trainer, itr_train,
                                                eval_iters)
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
            # threads and decode pools, and the sink is drained (its
            # buffered tail, a preemption's record among it) even when a
            # close raises
            try:
                for it in all_iters:
                    it.close()
            finally:
                set_global(None)
                self._mon.close()

    def _task_test_io(self, itr, dev) -> int:
        assert itr is not None, "test_io requires a data block"
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start", **run_metadata(
                "test_io", self._cfg_stream, dev))
        start = time.time()
        n = 0
        for r in range(self.num_round):
            for batch in itr:
                n += batch.batch_size - batch.num_batch_padd
        dt = time.time() - start
        ips = n / max(dt, 1e-9)
        mon.line("test_io: %d instances in %.2fs (%.1f/sec)"
                 % (n, dt, ips))
        if mon.enabled:
            mon.emit("test_io", instances=n, wall_s=dt,
                     instances_per_sec=ips)
        return 0

    # -- preemption ------------------------------------------------------

    def _install_preempt_handlers(self):
        """Turn SIGTERM and SIGINT (the preemption notice) into a flag
        the train loop reads at its next dispatch boundary: an emergency
        snapshot beats dying mid-write. Only the main thread can own
        signal handlers; elsewhere the process keeps its own."""
        if threading.current_thread() is not threading.main_thread():
            return []
        installed = []

        def _on_signal(signum, frame):
            self._preempt_signum = signum

        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                installed.append((s, signal.signal(s, _on_signal)))
            except (ValueError, OSError) as e:
                self._mon.warn_once(
                    "preempt_handler_unavailable",
                    "cannot install handler for signal %s (%s); "
                    "preemption will not trigger an emergency "
                    "snapshot" % (s, e))
        return installed

    @staticmethod
    def _restore_handlers(installed) -> None:
        for s, old in installed:
            try:
                signal.signal(s, old)
            except (ValueError, OSError, TypeError):
                pass    # best effort on the exit path

    def _preempt_exit(self, ckpt, round_idx: int) -> int:
        """The emergency snapshot at the current dispatch boundary,
        committed inline after the writer drains, under ``round_idx``
        (the rounds completed): resume re-runs the interrupted round
        from its start with the mid-round weights."""
        signum = int(self._preempt_signum or 0)
        mon = self._mon
        if self.silent == 0:
            mon.line("preempted by signal %d: emergency snapshot "
                     "%04d.model.npz" % (signum, round_idx))
        ckpt.save(round_idx, emergency=True)
        ckpt.close()
        if mon.enabled:
            mon.emit("preempt", signal=signum, round=round_idx,
                     exit_code=EXIT_PREEMPTED)
        return EXIT_PREEMPTED

    # -- train -----------------------------------------------------------

    def _task_train(self, trainer, itr_train, eval_iters) -> int:
        assert itr_train is not None, "train requires a data block"
        mon = self._mon
        if trainer._mon is not mon:      # run() attached it already
            trainer.set_monitor(mon)     # (no duplicate model records)
        if hasattr(itr_train, "set_transform"):
            # threadbuffer chains stage each batch on the device in the
            # prefetch thread (from a pinned ring on CUDA), overlapped
            # with the updates
            itr_train.set_transform(
                trainer.device_put_batch,
                pin_memory=trainer.device.type == "cuda")
        monitored = mon.enabled
        io_hist = None
        if monitored:
            mon.emit("run_start", **run_metadata(
                self.task, self._cfg_stream, trainer.device))
            # the batch-fetch wait histogram of the prefetch chain,
            # attached only under a monitor: the default path reads no
            # clock per batch
            io_hist = enable_chain_wait_stats(itr_train)
        k = self.dispatch_period
        ckpt = CheckpointManager(
            trainer, self._model_path, model_dir=self.model_dir,
            monitor=mon, async_=bool(self.checkpoint_async),
            fsync=bool(self.checkpoint_fsync), keep=self.keep_snapshots)
        if self.precompile:
            trainer.precompile()
        start = time.time()

        def _progress(r, nbatch):
            if (self.print_step and nbatch % self.print_step < k
                    and self.silent == 0):
                mon.line("round %8d:[%8d] %ld sec elapsed"
                         % (r, nbatch, int(time.time() - start)))

        # installed inside the try, so every exit path restores the
        # process's handlers
        handlers = []
        try:
            handlers = self._install_preempt_handlers()
            for r in range(self.start_counter - 1, self.num_round):
                # r rounds have completed
                if self._preempt_signum is not None:
                    return self._preempt_exit(ckpt, r)
                if monitored:
                    mon.emit("round_start", round=r)
                # the trace runs under monitor = none too; it starts
                # before the round's throughput window opens, so the
                # profiler's start-up is not counted as the round's
                mon.maybe_start_trace(r)
                trainer.start_round(r)
                nbatch = 0
                window = []
                t_wait = time.perf_counter() if monitored else 0.0
                for batch in itr_train:
                    if monitored:
                        # the wait half of the step-time split: the time
                        # this loop waited on the iterator since the
                        # last dispatch
                        trainer.note_data_wait(
                            time.perf_counter() - t_wait)
                    if k == 1:
                        trainer.update(batch)
                        nbatch += 1
                    else:
                        window.append(batch)
                        if len(window) < k:
                            if monitored:
                                t_wait = time.perf_counter()
                            continue
                        trainer.update_many(window)
                        nbatch += len(window)
                        window = []
                    _progress(r, nbatch)
                    if self._preempt_signum is not None:
                        return self._preempt_exit(ckpt, r)
                    if monitored:
                        t_wait = time.perf_counter()
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
                    mon.line(line)
                mon.maybe_stop_trace(r)
                if monitored:
                    self._emit_round_end(trainer, itr_train, io_hist, r)
                if self.save_period and (r + 1) % self.save_period == 0:
                    # on the background writer under checkpoint_async
                    ckpt.save(r + 1)
            # drain the writer before run_end: every checkpoint record
            # lands in the stream, and the last commit is durable before
            # the exit code says so
            ckpt.close()
        finally:
            ckpt.close()
            self._restore_handlers(handlers)
        if self.silent == 0:
            mon.line("updating end, %ld sec in all"
                     % int(time.time() - start))
        if monitored:
            c = trainer.counters_snapshot()
            mon.emit("run_end", wall_s=time.time() - start,
                     steps=int(c["steps"]), examples=int(c["examples"]))
        return 0

    # -- continual -------------------------------------------------------

    def _task_continual(self, cfg, trainer, itr_train, eval_iters) -> int:
        """Continual train-while-serve: one process trains on a looping
        iterator while its fleet serves ``model_dir``; every
        ``continual_export_every`` updates the generation pipeline runs
        (eval gate -> verified snapshot -> sealed bundle -> watcher
        ``notify()`` -> flip), for ``continual_generations``
        generations. SIGTERM or SIGINT takes the emergency-snapshot
        exit (75), as ``task = train`` does."""
        assert itr_train is not None, "continual requires a data block"
        from .continual import ContinualLoop
        mon = self._mon
        if hasattr(itr_train, "set_transform"):
            # the batches stage on the device in the prefetch thread,
            # as in _task_train
            itr_train.set_transform(
                trainer.device_put_batch,
                pin_memory=trainer.device.type == "cuda")
        if mon.enabled:
            mon.emit("run_start", **run_metadata(
                "continual", self._cfg_stream, trainer.device))
        handlers = []
        try:
            handlers = self._install_preempt_handlers()
            loop = ContinualLoop(
                cfg, trainer, itr_train, eval_iters,
                model_dir=self.model_dir,
                path_for=self._model_path,
                monitor=mon,
                should_stop=lambda: self._preempt_signum is not None,
                checkpoint_async=bool(self.checkpoint_async),
                checkpoint_fsync=bool(self.checkpoint_fsync),
                keep_snapshots=self.keep_snapshots,
                start_counter=self.start_counter,
                dispatch_period=self.dispatch_period)
            summary = loop.run()
        finally:
            self._restore_handlers(handlers)
        if summary["preempted"]:
            signum = int(self._preempt_signum or 0)
            if self.silent == 0:
                mon.line("continual: preempted by signal %d after %d "
                         "generation(s); emergency snapshot committed"
                         % (signum, summary["deployed"]))
            if mon.enabled:
                mon.emit("preempt", signal=signum, round=trainer.round,
                         exit_code=EXIT_PREEMPTED)
            return EXIT_PREEMPTED
        if mon.enabled:
            mon.emit("task_end", task="continual",
                     generations=summary["deployed"],
                     requests=summary["requests"])
        return 0

    def _emit_round_end(self, trainer, itr_train, io_hist, r: int) -> None:
        """A round's closing records: ``round_end`` (its throughput
        window), ``memory``, ``io_wait`` (the batch-fetch waits, reset)
        and ``pipeline`` (buffer reuse, the staging copies' time and
        overlap, reset)."""
        mon = self._mon
        mon.emit("round_end", round=r,
                 examples=trainer.last_round_examples,
                 wall_s=trainer.last_round_wall_s,
                 examples_per_sec=trainer.last_round_examples_per_sec)
        mon.emit("memory", round=r,
                 **device_memory_snapshot(trainer.device))
        if io_hist is not None:
            mon.emit("io_wait", round=r, **io_hist.snapshot())
            io_hist.reset()
        ps = pipeline_snapshot(itr_train)
        if ps is not None:
            mon.emit("pipeline", round=r, **ps)

    # -- serve and quantize ----------------------------------------------

    def _task_serve(self, cfg, itr, dev) -> int:
        """Long-lived concurrent predictor: load the snapshot into a
        frozen bucketed engine behind the dynamic batcher, then drive
        ``serve_clients`` threaded closed-loop clients over the
        iterator's examples."""
        assert itr is not None, "serve requires an iterator block"
        from .serve import ServeSession, run_closed_loop
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start",
                     **run_metadata("serve", self._cfg_stream, dev))
        sess = ServeSession(cfg, model_path=self.model_in, monitor=mon,
                            device=dev)
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
        mon.line(
            "serve: %d ok / %d busy / %d timeout / %d error requests "
            "(%d rows) in %.2fs, p50 %.1f ms p99 %.1f ms, fill %.2f, "
            "compiles after warmup %d"
            % (agg["ok"], agg["busy"], agg["timeout"], agg["error"],
               summary["rows"], agg["wall_s"],
               summary["latency_p50_ms"], summary["latency_p99_ms"],
               summary["fill_rate"], summary["compile_events"]))
        if mon.enabled:
            mon.emit("task_end", task="serve", requests=agg["ok"],
                     rows=summary["rows"])
        return 0

    def _task_serve_fleet(self, cfg, dev) -> int:
        """Fleet serving: N routed engines with per-tenant quotas and
        checkpoint-driven hot-swap behind the HTTP/JSON and binary
        listeners, for ``serve_fleet_duration_s`` seconds (0: until
        SIGTERM or SIGINT, the deployment mode), then a drain of every
        engine."""
        from .serve import FleetServer
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start",
                     **run_metadata("serve_fleet", self._cfg_stream, dev))
        fleet = FleetServer(cfg, monitor=mon, device=dev)
        handlers = []
        try:
            fleet.start()
            mon.line("serve_fleet: listening http=%s binary=%s, "
                     "models: %s"
                     % (fleet.http_port, fleet.binary_port,
                        ", ".join("%s@%04d" % (d["model"], d["counter"])
                                  for d in fleet.describe())))
            handlers = self._install_preempt_handlers()
            self._wait_for_stop(fleet.fleet_cfg.duration_s)
            summary = fleet.close()
        finally:
            # a failure between start and close still stops the
            # listener and watcher threads and the engines (close is
            # idempotent: a no-op after the drain above)
            fleet.close(drain=False)
            self._restore_handlers(handlers)
        c = summary["requests"]
        mon.line("serve_fleet: %d requests (%d ok / %d over_quota / "
                 "%d busy / %d timeout / %d error), %d hot-swaps"
                 % (c["requests"], c["ok"], c["over_quota"], c["busy"],
                    c["timeout"], c["error"], summary["swaps"]))
        if mon.enabled:
            mon.emit("task_end", task="serve_fleet",
                     requests=c["requests"], swaps=summary["swaps"])
        return 0

    def _task_fleet(self, cfg, conf_path: str,
                    cli_overrides: List[str]) -> int:
        """The horizontal fleet: a front-of-fleet balancer and an
        autoscale controller (and an optional canary rollout) over N
        shared-nothing ``serve_fleet`` replica processes spawned from
        this same config file. Runs for ``fleet_duration_s`` seconds (0:
        until SIGTERM or SIGINT), then drains every replica in scale-in
        order on every exit path: deroute, wait for in-flight, SIGTERM.
        The process resolves no device; the replicas inherit ``dev``
        through the config file and ``cli_overrides``."""
        from .fleet import FleetController
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start", **run_metadata(
                "fleet", self._cfg_stream, torch.device("cpu")))
        controller = FleetController(cfg, conf_path, monitor=mon,
                                     extra_overrides=cli_overrides)
        handlers = []
        try:
            controller.start()
            bal = controller.balancer
            mon.line("fleet: balancer http=%s binary=%s, %d replicas "
                     "serving %s%s"
                     % (bal.http_port, bal.binary_port,
                        controller.ready_count(),
                        controller.current_version(),
                        ", canary %s armed"
                        % controller.canary.canary_version
                        if controller.canary else ""))
            handlers = self._install_preempt_handlers()
            self._wait_for_stop(controller.tier.duration_s)
        finally:
            # a failure between start and the wait must still stop the
            # scale thread, drain the replicas and close the listeners
            # (close is idempotent per component)
            summary = controller.close()
            self._restore_handlers(handlers)
        mon.line("fleet: %d requests (%d ok / %d shed / %d error, "
                 "%d retries recovered)%s"
                 % (summary.get("requests", 0), summary.get("ok", 0),
                    summary.get("shed", 0), summary.get("errors", 0),
                    summary.get("retries", 0),
                    ", canary %s" % summary["canary"]
                    if "canary" in summary else ""))
        if mon.enabled:
            mon.emit("task_end", task="fleet",
                     requests=summary.get("requests", 0))
        return 0

    def _task_fleet_balancer(self, cfg) -> int:
        """One door of the sharded front tier: a standalone
        :class:`~cxxnet_tpu_torch.fleet.FleetBalancer` that publishes
        its ports through ``fleet_port_file`` and reconciles replicas
        and tier peers from the shared endpoint registry on every sync
        tick. Runs for ``fleet_duration_s`` seconds (0: until SIGTERM or
        SIGINT)."""
        from .fleet import FleetBalancer, FleetTierConfig
        from .fleet.placement import (EndpointRegistry,
                                      sync_from_registry,
                                      write_endpoint_file)
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start", **run_metadata(
                "fleet_balancer", self._cfg_stream, torch.device("cpu")))
        tier = FleetTierConfig(cfg)
        bal = FleetBalancer(tier, cfg, monitor=mon)
        registry = EndpointRegistry(tier.registry_path)
        handlers = []
        try:
            bal.start()
            sync_from_registry(bal, registry, tier.balancer_id)
            if tier.port_file:
                write_endpoint_file(
                    tier.port_file,
                    {"pid": os.getpid(), "http_port": bal.http_port,
                     "binary_port": bal.binary_port})
            mon.line("fleet_balancer: %s http=%s binary=%s, "
                     "registry %s"
                     % (tier.balancer_id, bal.http_port,
                        bal.binary_port, tier.registry_path))
            handlers = self._install_preempt_handlers()
            # the sync cadence bounds how fast this door sees a drain
            # or a new replica: well under the controller's drain wait,
            # and cheap (an mtime stat when nothing changed)
            self._wait_for_stop(
                tier.duration_s, min(0.2, tier.gossip_s),
                lambda: sync_from_registry(bal, registry,
                                           tier.balancer_id))
        finally:
            summary = bal.close()
            self._restore_handlers(handlers)
        mon.line("fleet_balancer: %s served %d requests (%d ok / "
                 "%d shed / %d error, %d retries recovered)"
                 % (tier.balancer_id, summary.get("requests", 0),
                    summary.get("ok", 0), summary.get("shed", 0),
                    summary.get("errors", 0),
                    summary.get("retries", 0)))
        if mon.enabled:
            mon.emit("task_end", task="fleet_balancer",
                     requests=summary.get("requests", 0))
        return 0

    def _wait_for_stop(self, duration_s: float, period_s: float = 0.05,
                       tick=None) -> None:
        """Sleep in ``period_s`` steps (calling ``tick`` before each)
        until ``duration_s`` seconds passed (0: forever) or SIGTERM or
        SIGINT arrived."""
        deadline = time.monotonic() + duration_s if duration_s > 0 \
            else None
        while self._preempt_signum is None:
            if deadline is not None and time.monotonic() >= deadline:
                break
            if tick is not None:
                tick()
            time.sleep(period_s)

    def _task_export(self, cfg, dev) -> int:
        """Seal ``model_in`` (a snapshot or a bundle) into a bundle at
        ``export_out`` (default: the ``NNNN.model.bundle`` beside it):
        load it into a frozen engine of the serve contract's ladder, run
        each bucket once (the kernels the serve path launches load or
        build there), and commit the snapshot, those kernel libraries,
        the fingerprint and the manifest as one two-phase bundle
        (``artifact/bundle.py``)."""
        from .artifact.bundle import default_bundle_path, export_bundle
        from .serve import ServeConfig, build_engine
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start",
                     **run_metadata("export", self._cfg_stream, dev))
        sc = ServeConfig(cfg)
        engine = build_engine(cfg, self.model_in, buckets=sc.buckets,
                              max_batch=sc.max_batch, node=sc.node,
                              device=dev, monitor=mon)
        compiled = engine.warmup()
        out = self.export_out or default_bundle_path(self.model_in)
        stats = export_bundle(engine, out, node=sc.node, monitor=mon)
        if mon.enabled:
            mon.emit("export", **stats)
        mon.line("export: sealed %s -> %s (%d programs compiled, %d "
                 "serialized, %d bytes)"
                 % (self.model_in, out, compiled, stats["programs"],
                    stats["bytes"]))
        if mon.enabled:
            mon.emit("task_end", task="export", outfile=out)
        return 0

    def _task_build_index(self, cfg, itr, dev) -> int:
        """Embed the iterator's corpus through the frozen serve net and
        seal model + index as one bundle: the valid rows go through the
        bucketed engine (the dispatch ``/v1/embed`` serves), the exact
        index is built over the embeddings, a retrieval engine warms on
        the device (its self-recall spot check is the ``retrieval``
        record), and everything commits as one digest-verified
        artifact."""
        assert itr is not None, "build_index requires an iterator block"
        from .artifact.bundle import default_bundle_path, export_bundle
        from .retrieval import self_recall
        from .serve import ServeConfig, build_engine
        from .serve.server import build_retrieval
        mon = self._mon
        t_start = time.time()
        if mon.enabled:
            mon.emit("run_start",
                     **run_metadata("build_index", self._cfg_stream, dev))
        sc = ServeConfig(cfg)
        engine = build_engine(cfg, self.model_in, buckets=sc.buckets,
                              max_batch=sc.max_batch, node=sc.node,
                              device=dev, monitor=mon)
        compiled = engine.warmup()
        # corpus pass: valid rows only, private copies (iterator ring
        # buffers recycle their arrays), capped by index_rows
        parts, got, cap = [], 0, self.index_rows
        for batch in itr:
            n = batch.batch_size - batch.num_batch_padd
            if cap and got + n > cap:
                n = cap - got
            if n > 0:
                parts.append(np.array(batch.data[:n], np.float32))
                got += n
            if cap and got >= cap:
                break
        assert parts, "build_index: iterator produced no examples"
        out = self.export_out or default_bundle_path(self.model_in)
        rengine = build_retrieval(engine, np.concatenate(parts, axis=0), sc,
                                  monitor=mon, out=out, t0=t_start)
        index = rengine.index
        t_rec = time.time()
        rec = self_recall(rengine)
        if mon.enabled:
            mon.emit("retrieval", queries=min(8, index.rows), k=1,
                     metric=index.metric, recall=rec,
                     wall_ms=(time.time() - t_rec) * 1e3)
        stats = export_bundle(engine, out, node=sc.node, monitor=mon,
                              retrieval=rengine)
        if mon.enabled:
            mon.emit("export", **stats)
        mon.line(
            "build_index: %d rows x %d dims (%s) sealed with %s -> %s "
            "(self-recall@1 %.3f, %d+%d programs, %d index bytes)"
            % (index.rows, index.dim, index.metric, self.model_in,
               out, rec, compiled, len(rengine.buckets), index.nbytes))
        if mon.enabled:
            mon.emit("task_end", task="build_index", outfile=out,
                     rows=index.rows)
        return 0

    def _task_quantize(self, cfg, itr, dev) -> int:
        """Post-training calibration: stream the iterator through the
        frozen eval net collecting per-channel ranges, parity-gate the
        quantized graph against the f32 eval outputs over the same
        batches, and commit a snapshot whose ``quant/`` arrays carry the
        ranges (what ``serve_dtype = int8`` loads)."""
        assert itr is not None, "quantize requires an iterator block"
        from .nnet.quantize import Calibrator, normalize_serve_dtype
        mon = self._mon
        t_start = time.time()
        qdtype = normalize_serve_dtype(self.quantize_dtype)
        if qdtype not in ("int8", "fp8"):
            raise ValueError(
                "quantize_dtype must be int8 or fp8, got %r"
                % self.quantize_dtype)
        if mon.enabled:
            mon.emit("run_start",
                     **run_metadata("quantize", self._cfg_stream, dev))
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
        if mon.enabled:
            mon.emit("quantize", dtype=rep.get("dtype", qdtype),
                     batches=len(batches), layers=rep.get("layers", 0),
                     fallback_layers=rep.get("fallback_layers", 0),
                     parity_max_abs=max_abs, parity_mean_abs=mean_abs,
                     agree_rate=agree_rate, out=out if ok else "",
                     wall_ms=(time.time() - t_start) * 1e3)
        mon.line(
            "quantize[%s]: %d layers (%d fallback) over %d batches, "
            "parity mean|Δ| %.2g max|Δ| %.2g agree %.3f — %s"
            % (rep.get("dtype", qdtype), rep.get("layers", 0),
               rep.get("fallback_layers", 0), len(batches), mean_abs,
               max_abs, agree_rate,
               ("wrote %s" % out) if ok else
               "PARITY GATE FAILED (eps %g), no snapshot written"
               % self.quantize_parity_eps))
        if mon.enabled:
            mon.emit("task_end", task="quantize",
                     outfile=out if ok else "", rows=nrow)
        return 0 if ok else 1

    # -- pred, extract, get_weight ---------------------------------------

    def _task_predict(self, trainer, itr) -> int:
        assert itr is not None, "pred requires an iterator"
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start", **run_metadata(
                "pred", self._cfg_stream, trainer.device))
        nrow = 0
        with open_stream(self.name_pred, "w") as f:
            for batch in itr:
                for v in trainer.predict(batch):
                    f.write("%g\n" % v)
                    nrow += 1
        mon.line("finished prediction, write into %s" % self.name_pred)
        if mon.enabled:
            mon.emit("task_end", task="pred", outfile=self.name_pred,
                     rows=nrow)
        return 0

    def _task_extract(self, trainer, itr) -> int:
        assert itr is not None, "extract requires an iterator"
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start", **run_metadata(
                "extract", self._cfg_stream, trainer.device))
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
        mon.line("finished feature extraction, write into %s"
                 % self.name_pred)
        if mon.enabled:
            mon.emit("task_end", task="extract", outfile=self.name_pred,
                     rows=nrow)
        return 0

    def _task_get_weight(self, trainer) -> int:
        assert self.weight_layer, "get_weight requires weight_layer"
        mon = self._mon
        if mon.enabled:
            mon.emit("run_start", **run_metadata(
                "get_weight", self._cfg_stream, trainer.device))
        w = trainer.get_weight(self.weight_layer, self.weight_tag)
        rows = w.reshape(w.shape[0], -1) if w.ndim > 1 else w[None, :]
        if self.output_format == "txt":
            with open_stream(self.weight_filename, "w") as f:
                np.savetxt(f, rows, fmt="%g")
        else:                            # raw float32
            with open_stream(self.weight_filename, "wb") as f:
                f.write(np.ascontiguousarray(rows, "<f4").tobytes())
        mon.line("weight %s:%s %s written to %s"
                 % (self.weight_layer, self.weight_tag, w.shape,
                    self.weight_filename))
        if mon.enabled:
            mon.emit("task_end", task="get_weight",
                     outfile=self.weight_filename)
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    return LearnTask().run(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
