"""The continual supervisor: train -> gate -> export -> hot-swap, xN
(counterpart of ``cxxnet_tpu/continual/loop.py``).

One process owns both halves of the production loop:

- the **trainer** runs on a looping data iterator (epochs stream
  back-to-back; round telemetry keeps its per-epoch shape), driven in
  ``dispatch_period`` windows as the ``task = train`` loop drives it;
- the **fleet front end** (:class:`~cxxnet_tpu_torch.serve.frontend.
  FleetServer`) serves live traffic from ``model_dir`` the whole time,
  hot-swapping through its :class:`~cxxnet_tpu_torch.serve.swap.
  SnapshotWatcher`.

Every ``continual_export_every`` applied updates the loop runs one
**generation attempt**:

1. **eval gate** — a full eval pass; the gated metric must not worsen
   against the best deployed generation (``continual_gate =
   min|max|off``, slack ``continual_gate_eps``). A failed gate skips
   the snapshot and the export: the fleet keeps serving, training goes
   on, and the attempt is recorded (``action = "gate_skipped"``).
2. **snapshot** — a digest-verified commit through the
   :class:`~cxxnet_tpu_torch.nnet.checkpoint.CheckpointManager` (its
   writer is drained before the export reads the file back).
3. **export** — :class:`GenerationExporter` seals the snapshot: the
   first generation builds and warms a serve engine (its kernels load
   or build once), later generations reload the weights in place
   (``NetTrainer.load_weights_inplace``) and re-seal, building no
   engine and running no ``nvcc``.
4. **flip** — ``FleetServer.notify_watchers()`` wakes the poll thread
   the instant the bundle commits; the watcher boots the bundle as a
   shadow session and flips. The first generation boots the fleet
   instead.

The loop keeps the CLI's preemption contract: ``should_stop`` is read
at every dispatch and pipeline boundary, and a preempted run commits
an emergency snapshot, drains the fleet and reports ``preempted``, so
that ``main`` exits 75. ``continual_index_rows > 0`` tees the first N
valid raw training rows off the stream as a retrieval corpus; each
generation's export re-embeds them through its own weights and seals
the rebuilt index into its bundle, so the flip carries model and index
as one pair.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..artifact.bundle import default_bundle_path, export_bundle
from ..nnet.checkpoint import CheckpointManager
from ..serve import FleetServer, ServeConfig, build_engine
from ..serve.server import build_retrieval

_GATE_MODES = ("min", "max", "off")
_TASKS = ("train", "finetune")


class ContinualConfig:
    """Parsed ``continual_*`` keys, as the reference reads them:

    - ``continual_generations`` — deployed generations before a clean
      exit (>= 1);
    - ``continual_export_every`` — applied updates between generation
      attempts (required, > 0; an attempt lands on a dispatch window's
      edge, so it may run up to ``dispatch_period - 1`` updates late);
    - ``continual_task`` — ``train`` (a fresh init, or ``model_in``
      resumed) or ``finetune`` (the carry from ``model_in``);
    - ``continual_eval`` / ``continual_metric`` — the eval block and
      metric the gate reads (default: the first of each);
    - ``continual_gate`` — ``min`` (the default), ``max`` or ``off``;
      ``continual_gate_eps`` its slack;
    - ``continual_swap_timeout_s`` — how long to wait for the flip
      before recording ``swap_timeout``;
    - ``continual_linger_s`` — serve-only time after the last
      generation, before the drain;
    - ``continual_max_updates`` — a bound on applied updates (0: none);
    - ``continual_index_rows`` — when > 0, the first N valid training
      rows are captured as a retrieval corpus, re-embedded with every
      generation's weights and sealed into its bundle (0: index-less
      bundles).
    """

    def __init__(self, cfg: Sequence[Tuple[str, str]]):
        self.generations = 3
        self.export_every = 0
        self.task = "train"
        self.eval_name = ""
        self.metric = ""
        self.gate = "min"
        self.gate_eps = 0.0
        self.swap_timeout_s = 120.0
        self.linger_s = 0.0
        self.max_updates = 0
        self.index_rows = 0
        for name, val in cfg:
            if name == "continual_generations":
                self.generations = int(val)
            if name == "continual_export_every":
                self.export_every = int(val)
            if name == "continual_task":
                if val not in _TASKS:
                    raise ValueError(
                        "continual_task must be train|finetune, got %r"
                        % val)
                self.task = val
            if name == "continual_eval":
                self.eval_name = val
            if name == "continual_metric":
                self.metric = val
            if name == "continual_gate":
                if val not in _GATE_MODES:
                    raise ValueError(
                        "continual_gate must be min|max|off, got %r"
                        % val)
                self.gate = val
            if name == "continual_gate_eps":
                self.gate_eps = float(val)
            if name == "continual_swap_timeout_s":
                self.swap_timeout_s = float(val)
            if name == "continual_linger_s":
                self.linger_s = float(val)
            if name == "continual_max_updates":
                self.max_updates = int(val)
            if name == "continual_index_rows":
                self.index_rows = int(val)
        if self.generations < 1:
            raise ValueError("continual_generations must be >= 1")
        if self.export_every < 1:
            raise ValueError(
                "task=continual requires continual_export_every >= 1 "
                "(applied updates between generation attempts)")

    def passes(self, value: float, best: Optional[float]) -> bool:
        if self.gate == "off" or best is None:
            return True
        if self.gate == "min":
            return value <= best + self.gate_eps
        return value >= best - self.gate_eps

    def ratchet(self, value: float, best: Optional[float]) -> float:
        """The best after a deploy: the best value ever deployed, not
        the last (with eps slack, the last would let the metric drift
        one eps a generation)."""
        if best is None or self.gate == "off":
            return value
        return min(best, value) if self.gate == "min" \
            else max(best, value)


class GenerationExporter:
    """Per-generation ``task = export`` without a per-generation engine:
    the first :meth:`export` builds and warms a serve engine from the
    snapshot (its kernel libraries load, or build, there); later calls
    reload the weights in place and re-seal. The engine never shares
    tensors with the training trainer."""

    def __init__(self, cfg: Sequence[Tuple[str, str]], monitor=None,
                 device=None):
        self.cfg = list(cfg)
        self.sc = ServeConfig(self.cfg)
        self._mon = monitor
        self.device = device
        self.engine = None
        self.engine_builds = 0

    def export(self, snapshot: str, out: str,
               corpus: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Seal ``snapshot`` into a committed bundle at ``out``; returns
        the ``export`` record fields. With a ``corpus`` (raw host rows),
        re-embed it through this generation's weights and seal the
        rebuilt index into the same bundle."""
        if self.engine is None:
            engine = build_engine(
                self.cfg, snapshot, buckets=self.sc.buckets,
                max_batch=self.sc.max_batch, node=self.sc.node,
                device=self.device, monitor=self._mon)
            # kept only once its warmup succeeded: later generations
            # must not seal an unwarmed engine
            engine.warmup()
            self.engine = engine
            self.engine_builds += 1
        else:
            self.engine.trainer.load_weights_inplace(snapshot)
        retrieval = None
        if corpus is not None and corpus.shape[0] > 0:
            retrieval = build_retrieval(self.engine, corpus, self.sc,
                                        monitor=self._mon, out=out)
        return export_bundle(self.engine, out, node=self.sc.node,
                             monitor=self._mon, retrieval=retrieval)


class ContinualLoop:
    """The supervisor. Construct with an initialized trainer and live
    iterators (the CLI's ``_task_continual`` wires them from the config),
    then :meth:`run`.

    ``should_stop`` is polled at every boundary (the CLI passes its
    SIGTERM/SIGINT flag); ``on_generation(record)`` fires after every
    generation attempt's record is emitted.
    """

    def __init__(self, cfg: Sequence[Tuple[str, str]], trainer,
                 itr_train, eval_iters: Sequence[Tuple[str, Any]],
                 model_dir: str,
                 path_for: Callable[[int], str],
                 monitor=None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 on_generation: Optional[Callable[[Dict], None]] = None,
                 checkpoint_async: bool = True,
                 checkpoint_fsync: bool = True,
                 keep_snapshots: int = 0,
                 start_counter: int = 1,
                 dispatch_period: int = 8):
        self.cfg = list(cfg)
        self.cc = ContinualConfig(self.cfg)
        self.trainer = trainer
        self.itr_train = itr_train
        self.eval_iters = list(eval_iters)
        self.model_dir = model_dir
        self.path_for = path_for
        self._mon = monitor
        self._should_stop = should_stop or (lambda: False)
        self._on_generation = on_generation
        self._ckpt_kw = dict(async_=bool(checkpoint_async),
                             fsync=bool(checkpoint_fsync),
                             keep=int(keep_snapshots))
        self.next_counter = max(1, int(start_counter))
        self.dispatch_period = max(1, int(dispatch_period))
        self.fleet: Optional[FleetServer] = None
        self.exporter = GenerationExporter(self.cfg, monitor=monitor,
                                           device=trainer.device)
        self._round = 0
        # the retrieval corpus (continual_index_rows): raw rows, not
        # embeddings: every generation re-embeds them through its own
        # weights, so the sealed index always matches its bundle
        self._corpus_parts: List[np.ndarray] = []
        self._corpus_got = 0
        # (model_id, router generation) -> that engine's last observed
        # compile count: each engine counts once in the total
        self._compile_counts: Dict[Tuple[str, int], int] = {}
        if self.cc.gate != "off" and not self.eval_iters:
            raise ValueError(
                "task=continual with continual_gate=%s needs an eval "
                "iterator block (or continual_gate = off)"
                % self.cc.gate)
        if self.cc.eval_name:
            names = [n for n, _ in self.eval_iters]
            if self.cc.eval_name not in names:
                raise ValueError(
                    "continual_eval %r names no eval block (have %s)"
                    % (self.cc.eval_name, names))

    # -- telemetry helpers -----------------------------------------------

    def _emit(self, event: str, **fields) -> None:
        if self._mon is not None and self._mon.enabled:
            self._mon.emit(event, **fields)

    def _line(self, text: str) -> None:
        if self._mon is not None:
            self._mon.line(text)
        else:
            print(text)

    # -- training drive --------------------------------------------------

    def _stream(self):
        """An endless batch stream with the per-epoch round bookkeeping
        of ``task = train`` (``round_start`` / ``round_end``)."""
        t = self.trainer
        while True:
            t.start_round(self._round)
            self._emit("round_start", round=self._round)
            n = 0
            for batch in self.itr_train:
                n += 1
                yield batch
            if n == 0:
                # an empty pass would spin here at full speed
                raise ValueError(
                    "task=continual: the training iterator produced "
                    "no batches in a full pass — check the data "
                    "block (round_batch may be dropping the only "
                    "partial batch)")
            t.end_round()
            self._emit("round_end", round=self._round,
                       examples=t.last_round_examples,
                       wall_s=t.last_round_wall_s,
                       examples_per_sec=t.last_round_examples_per_sec)
            self._round += 1

    def _capture_corpus(self, stream):
        """Tee the first ``continual_index_rows`` valid training rows off
        the batch stream as the retrieval corpus: float32 host copies
        (the iterator may recycle its buffers, and a staged batch lives
        on the device, its copy done once ``ready`` has fired)."""
        want = self.cc.index_rows
        for batch in stream:
            if self._corpus_got < want:
                n = min(batch.batch_size - batch.num_batch_padd,
                        want - self._corpus_got)
                if n > 0:
                    data = batch.data
                    if isinstance(data, torch.Tensor):
                        if getattr(batch, "ready", None) is not None:
                            batch.ready.synchronize()
                        data = data[:n].float().cpu().numpy()
                    self._corpus_parts.append(
                        np.array(np.asarray(data)[:n], np.float32))
                    self._corpus_got += n
            yield batch

    def _corpus_rows(self) -> Optional[np.ndarray]:
        if not self._corpus_parts:
            return None
        if len(self._corpus_parts) > 1:
            self._corpus_parts = [
                np.concatenate(self._corpus_parts, axis=0)]
        return self._corpus_parts[0]

    def _train_until(self, stream, target_updates: int) -> bool:
        """Advance the trainer to ``target_updates`` applied updates in
        dispatch windows; False when preempted on the way. An attempt
        may overshoot by up to ``dispatch_period - 1`` updates, never
        undershoot."""
        t = self.trainer
        k = self.dispatch_period
        while t.update_counter < target_updates:
            if self._should_stop():
                return False
            window = [next(stream) for _ in range(k)]
            if k == 1:
                t.update(window[0])
            else:
                t.update_many(window)
        return True

    # -- the generation pipeline -----------------------------------------

    def _gate_value(self) -> Tuple[str, str, float]:
        """(eval block, metric tag, value) of the gated metric: one full
        eval pass (which also lands as an ``eval`` record)."""
        if not self.eval_iters:
            return "", "", -1.0
        name, itr = self.eval_iters[0]
        if self.cc.eval_name:
            name, itr = next((n, it) for n, it in self.eval_iters
                             if n == self.cc.eval_name)
        line, vals = self.trainer.evaluate_metrics(itr, name)
        if not vals:
            if self.cc.gate == "off":
                return name, "", -1.0
            raise ValueError(
                "task=continual: no metrics configured — the eval "
                "gate needs at least one metric[...] key "
                "(or continual_gate = off)")
        tag = self.cc.metric or next(iter(vals))
        if tag not in vals:
            raise ValueError(
                "continual_metric %r is not among the configured "
                "metrics %s" % (tag, sorted(vals)))
        self._line("[gen %d]%s" % (self.next_counter, line))
        return name, tag, vals[tag]

    def _note_engine_compiles(self) -> None:
        """Record the current engines' post-warmup compile counters,
        keyed by (model, router generation)."""
        if self.fleet is None:
            return
        for mid in self.fleet.router.ids():
            e = self.fleet.router.resolve(mid)
            snap = e.session.engine.counters_snapshot()
            self._compile_counts[(e.model_id, e.generation)] = \
                int(snap["compile_events"])

    def _start_fleet(self) -> None:
        cfg = list(self.cfg)
        if not any(k == "serve_models" for k, _ in cfg):
            # the loop's own model_dir (model_in, the finetune source,
            # must not become a pinned serve source)
            cfg.append(("serve_models", "default=%s" % self.model_dir))
        self.fleet = FleetServer(cfg, monitor=self._mon,
                                 device=self.trainer.device)
        self.fleet.start()
        self._line(
            "continual: fleet listening http=%s binary=%s, models: %s"
            % (self.fleet.http_port, self.fleet.binary_port,
               ", ".join("%s@%04d" % (d["model"], d["counter"])
                         for d in self.fleet.describe())))

    def _await_swap(self, counter: int) -> Tuple[bool, float]:
        """Wait for the watcher's flip to ``counter``; (flipped,
        seconds)."""
        mid = self.fleet.router.default_id
        t0 = time.monotonic()
        deadline = t0 + self.cc.swap_timeout_s
        while time.monotonic() < deadline:
            if self.fleet.router.resolve(mid).counter >= counter:
                return True, time.monotonic() - t0
            if self._should_stop():
                break
            time.sleep(0.02)
        return False, time.monotonic() - t0

    def _attempt(self, best: Optional[float]
                 ) -> Tuple[str, Optional[float], Dict[str, Any]]:
        """One generation attempt after its training window: gate ->
        snapshot -> export -> flip. Returns (action, new best,
        record)."""
        from ..layers import kernels
        t0 = time.perf_counter()
        counter = self.next_counter
        eval_name, tag, value = self._gate_value()
        rec: Dict[str, Any] = {
            "generation": counter, "counter": counter,
            "metric": tag, "value": value, "eval": eval_name,
            "train_updates": int(self.trainer.update_counter),
            "path": "",
        }
        if not self.cc.passes(value, best):
            rec.update(action="gate_skipped", gate_best=best,
                       wall_ms=(time.perf_counter() - t0) * 1e3)
            self._line(
                "continual: generation %d gate FAILED (%s %g vs best "
                "%g + eps %g) — keeping generation %d serving"
                % (counter, tag, value, best, self.cc.gate_eps,
                   counter - 1))
            return "gate_skipped", best, rec
        self._ckpt.save(counter)
        self._ckpt.wait()                # export reads the file back
        snap = self.path_for(counter)
        out = default_bundle_path(snap)
        builds, nvcc = self.exporter.engine_builds, kernels.nvcc_runs
        t_exp = time.perf_counter()
        try:
            stats = self.exporter.export(snap, out,
                                         corpus=self._corpus_rows())
        except Exception as e:
            # failing to upgrade must not take down what serves: the
            # committed snapshot stays a valid swap target
            if self._mon is not None:
                self._mon.warn_once(
                    "continual_export_failed:%04d" % counter,
                    "generation %d export failed (%s); the fleet "
                    "keeps serving the previous generation" %
                    (counter, e))
            rec.update(action="export_failed", gate_best=best,
                       wall_ms=(time.perf_counter() - t0) * 1e3)
            # past the committed but unexported snapshot: a retry at
            # the same counter would see "already flipped"
            self.next_counter += 1
            return "export_failed", best, rec
        self._emit("export", **stats)
        rec.update(path=out,
                   export_ms=(time.perf_counter() - t_exp) * 1e3,
                   export_engine_built=self.exporter.engine_builds
                   > builds,
                   export_nvcc_runs=kernels.nvcc_runs - nvcc)
        if self.fleet is None:
            self._start_fleet()
            rec.update(boot=True, swapped=False, swap_wall_s=0.0)
        else:
            self._note_engine_compiles()  # the retiring engine's last
            self.fleet.notify_watchers()
            flipped, swap_wall = self._await_swap(counter)
            rec.update(boot=False, swapped=flipped,
                       swap_wall_s=round(swap_wall, 3))
            if not flipped:
                rec.update(action="swap_timeout", gate_best=best,
                           wall_ms=(time.perf_counter() - t0) * 1e3)
                self._line(
                    "continual: generation %d exported but the swap "
                    "did not land within %gs (the watcher flips it "
                    "on a later poll)"
                    % (counter, self.cc.swap_timeout_s))
                self.next_counter += 1
                return "swap_timeout", self.cc.ratchet(value, best), rec
        mid = self.fleet.router.default_id
        snap_c = self.fleet.router.resolve(mid) \
            .session.engine.counters_snapshot()
        rec.update(action="deployed", gate_best=best,
                   swap_compile_events=int(snap_c["compile_events"]),
                   export_programs=int(stats.get("programs", 0)),
                   wall_ms=(time.perf_counter() - t0) * 1e3)
        self._line(
            "continual: generation %d deployed (%s, %s) in %.1fs"
            % (counter,
               "%s %g" % (tag, value) if tag else "ungated",
               "fleet boot" if rec.get("boot") else
               "hot-swap %.2fs" % rec["swap_wall_s"],
               rec["wall_ms"] / 1e3))
        self.next_counter += 1
        return "deployed", self.cc.ratchet(value, best), rec

    # -- run ---------------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        cc = self.cc
        t_start = time.time()
        updates0 = int(self.trainer.update_counter)
        deployed = skipped = failed = 0
        best: Optional[float] = None
        preempted = False
        stream = self._stream()
        if cc.index_rows > 0:
            stream = self._capture_corpus(stream)
        self._ckpt = CheckpointManager(
            self.trainer, self.path_for, model_dir=self.model_dir,
            monitor=self._mon, **self._ckpt_kw)
        try:
            while deployed < cc.generations:
                if cc.max_updates and (self.trainer.update_counter
                                       - updates0) >= cc.max_updates:
                    self._line(
                        "continual: continual_max_updates=%d reached "
                        "with %d/%d generations deployed — stopping"
                        % (cc.max_updates, deployed, cc.generations))
                    break
                target = self.trainer.update_counter + cc.export_every
                if not self._train_until(stream, target) \
                        or self._should_stop():
                    preempted = True
                    break
                action, best, rec = self._attempt(best)
                self._emit("generation", **rec)
                if self._on_generation is not None:
                    self._on_generation(rec)
                if action == "deployed":
                    deployed += 1
                elif action == "gate_skipped":
                    skipped += 1
                else:
                    failed += 1
            if preempted:
                # the emergency snapshot at the boundary we stopped on;
                # it never gated, so it carries no bundle
                self._ckpt.save(self.next_counter, emergency=True)
            elif cc.linger_s > 0:
                deadline = time.monotonic() + cc.linger_s
                while time.monotonic() < deadline \
                        and not self._should_stop():
                    time.sleep(0.05)
        finally:
            self._ckpt.close()
            self._note_engine_compiles()  # the final engines
            fleet_summary: Dict[str, Any] = {}
            if self.fleet is not None:
                fleet_summary = self.fleet.close()
        updates = int(self.trainer.update_counter) - updates0
        wall = time.time() - t_start
        req = fleet_summary.get("requests", {})
        swaps = int(fleet_summary.get("swaps", 0))
        summary = {
            "generations": deployed + skipped + failed,
            "deployed": deployed, "gate_skipped": skipped,
            "export_failed": failed, "updates": updates,
            "swaps": swaps, "wall_s": round(wall, 3),
            "serve_compile_events": sum(self._compile_counts.values()),
            "requests": int(req.get("requests", 0)),
            "request_errors": int(req.get("error", 0)
                                  + req.get("closed", 0)),
            "preempted": preempted,
        }
        self._emit("continual", **summary)
        self._line(
            "continual: %d generation(s) deployed (%d gate-skipped, "
            "%d failed), %d updates, %d hot-swaps, %d serve requests "
            "(%d errors), %d post-warmup serve compiles, %ld sec"
            % (deployed, skipped, failed, updates, swaps,
               summary["requests"], summary["request_errors"],
               summary["serve_compile_events"], int(wall)))
        return summary
