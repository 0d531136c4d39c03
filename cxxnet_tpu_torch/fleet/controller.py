"""Telemetry-driven autoscale controller + replica lifecycle
(counterpart of ``cxxnet_tpu/fleet/controller.py``).

The :class:`FleetController` owns the whole tier (``task = fleet``):
it spawns the initial replicas through the
:class:`~cxxnet_tpu_torch.fleet.replica.ReplicaManager`, registers them with
the :class:`~cxxnet_tpu_torch.fleet.balancer.FleetBalancer`, then runs a
scale loop that every ``fleet_scale_interval_s``:

1. **self-heals** — a replica that died (crash, OOM-kill) is derouted
   and, when the fleet is below ``fleet_min_replicas``, replaced;
2. **steps the canary rollout** when one is armed
   (``fleet/canary.py``);
3. **classifies load** from the balancer's window (queued rows vs
   fleet dispatch capacity, shed rate, p99 vs ``fleet_slo_p99_ms``)
   via the pure :func:`classify_load`, and scales out after sustained
   overload / drains one replica in after sustained idleness — the
   zero-drop order: stop routing, wait for in-flight, SIGTERM.

Scale-out is cheap because replicas boot from the same sealed bundle
(no ``nvcc`` on a bundle boot, ``artifact/bundle.py``); device-memory honesty is
enforced where the weights land: ``serve_device_mem_budget`` passes
through to every replica, whose router refuses an over-budget model
set at boot — a spawn that would not fit fails loudly instead of
packing devices past the budget.

Every action emits a schema-validated ``fleet_scale`` record.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..monitor import SafeEmitter
from .balancer import FleetBalancer
from .canary import CanaryRollout
from .config import FleetTierConfig
from .placement import (BalancerManager, EndpointRegistry,
                        endpoint_entry)
from .replica import ReplicaManager, ReplicaProcess, SpawnError


def classify_load(stats: Dict[str, Any],
                  tier: FleetTierConfig) -> Tuple[str, str]:
    """Pure load classification of one balancer window:
    ``("overload" | "idle" | "steady", reason)``.

    - queued rows are normalized by the fleet's dispatch capacity
      (ready replicas x max_batch): a ratio above ``fleet_queue_hi``
      means the queues cannot drain at this replica count;
    - a shed (busy/over-quota at the *balancer's* busy retry limit)
      rate above ``fleet_shed_hi`` means requests are already being
      turned away;
    - with ``fleet_slo_p99_ms`` set, an ok-request p99 above the SLO
      is overload even when queues look short (slow replicas);
    - idle needs the opposite of all three AND a queue ratio under
      ``fleet_queue_lo`` — with no traffic at all, an empty queue is
      enough.
    """
    ready = max(1, int(stats.get("ready", 0)))
    cap = max(1, int(stats.get("max_batch", 0))) * ready
    qratio = float(stats.get("queue_rows", 0)) / cap
    total = int(stats.get("requests", 0))
    shed_rate = float(stats.get("shed", 0)) / total if total else 0.0
    p99 = float(stats.get("p99_ms", 0.0))
    slo = tier.slo_p99_ms
    if qratio >= tier.queue_hi:
        return "overload", ("queued rows at %.2fx fleet dispatch "
                            "capacity" % qratio)
    if total and shed_rate > tier.shed_hi:
        return "overload", ("shed rate %.3f over fleet_shed_hi %.3f"
                            % (shed_rate, tier.shed_hi))
    if slo > 0 and stats.get("ok", 0) and p99 > slo:
        return "overload", ("p99 %.1f ms over SLO %.1f ms"
                            % (p99, slo))
    if total == 0 and stats.get("queue_rows", 0) == 0:
        return "idle", "no traffic"
    if qratio <= tier.queue_lo and shed_rate == 0.0 \
            and (slo <= 0 or p99 <= 0.5 * slo):
        return "idle", ("queue ratio %.3f under fleet_queue_lo %.3f"
                        % (qratio, tier.queue_lo))
    return "steady", "within thresholds"


def aggregate_windows(windows: Sequence[Dict[str, Any]]
                      ) -> Dict[str, Any]:
    """Fold per-door balancer windows into one fleet window for
    :func:`classify_load`. Traffic counters are disjoint per door and
    SUM; replica-state gauges (queued rows, ready count, dispatch
    capacity) are each door's view of the SAME replicas and take the
    max (summing would multiply the fleet's queue by N doors); p99 is
    the worst door (conservative for the SLO rule); coalesce fill is
    forward-weighted."""
    agg: Dict[str, Any] = {
        "requests": 0, "ok": 0, "shed": 0, "errors": 0,
        "p99_ms": 0.0, "queue_rows": 0, "max_batch": 0, "ready": 0,
        "replicas": 0, "window_s": 0.0, "channel_depth": 0,
        "forwards": 0, "coalesce_fill": 0.0,
        "balancers": len(windows)}
    fill_weighted = 0.0
    for w in windows:
        for k in ("requests", "ok", "shed", "errors", "forwards",
                  "channel_depth"):
            agg[k] += int(w.get(k, 0))
        for k in ("queue_rows", "max_batch", "ready", "replicas"):
            agg[k] = max(agg[k], int(w.get(k, 0)))
        for k in ("p99_ms", "window_s"):
            agg[k] = max(agg[k], float(w.get(k, 0.0)))
        fill_weighted += float(w.get("coalesce_fill", 0.0)) \
            * int(w.get("forwards", 0))
    if agg["forwards"]:
        agg["coalesce_fill"] = round(
            fill_weighted / agg["forwards"], 3)
    return agg


class FleetController:
    """Owns balancer + replica manager + optional canary; the
    ``task = fleet`` body builds exactly one of these.

    ``manager`` is injectable so the scale/canary logic is testable
    against fake replicas (anything with the ReplicaManager surface:
    ``spawn`` / ``stop`` / ``poll_dead`` / ``replicas`` / ``close``).
    """

    def __init__(self, cfg: Sequence, conf_path: str = "",
                 monitor=None, manager=None,
                 extra_overrides: Sequence[str] = (),
                 bal_manager=None):
        self.cfg = list(cfg)
        self.tier = FleetTierConfig(self.cfg)
        self._mon = monitor
        self._safe_emit = SafeEmitter(monitor,
                                      "cxxnet_tpu_torch fleet controller")
        self.balancer = FleetBalancer(self.tier, self.cfg,
                                      monitor=monitor)
        self.manager = manager if manager is not None else \
            ReplicaManager(conf_path, self.tier,
                           extra_overrides=extra_overrides)
        # sharded front tier (fleet_balancers > 1): this process keeps
        # door b0 in-process (canary/window reads stay direct) and
        # spawns doors b1..bN-1 through the placement layer; discovery
        # for doors and clients is the endpoint-registry file. Like
        # ``manager``, ``bal_manager`` is injectable for tests.
        self.registry: Optional[EndpointRegistry] = None
        self.bal_manager = None
        if self.tier.balancers > 1 or self.tier.registry:
            self.registry = EndpointRegistry(self.tier.registry_path)
            self.registry.write([])
        if self.tier.balancers > 1:
            self.bal_manager = bal_manager if bal_manager is not None \
                else BalancerManager(
                    conf_path, self.tier,
                    extra_overrides=extra_overrides,
                    monitor_dir=self.tier.fleet_dir
                    if monitor is not None else "")
        # the model set newly spawned baseline replicas serve; a
        # canary promote repoints this at the new version
        self._lock = threading.Lock()
        self._current_models = list(self.tier.models)
        self._reps: Dict[str, ReplicaProcess] = {}
        self.canary: Optional[CanaryRollout] = None
        if self.tier.canary_source:
            self.canary = CanaryRollout(self, self.tier,
                                        monitor=monitor)
        self._stop = threading.Event()
        self._scale_thread: Optional[threading.Thread] = None
        self._overload_since: Optional[float] = None
        self._idle_since: Optional[float] = None

    # -- replica lifecycle -------------------------------------------------

    def current_models(self):
        with self._lock:
            return list(self._current_models)

    def set_current_models(self, models) -> None:
        with self._lock:
            self._current_models = list(models)

    def current_version(self) -> str:
        return self.tier.target_version(self.current_models())

    def ready_count(self, kind: Optional[str] = None) -> int:
        return len(self.balancer.replica_ids(kind=kind))

    def spawn_replica(self, models=None, kind: str = "baseline"
                      ) -> ReplicaProcess:
        """Spawn + register one replica (blocking until it serves);
        raises :class:`~cxxnet_tpu_torch.fleet.replica.SpawnError` upward —
        callers decide whether a failed spawn is fatal (boot) or a
        telemetry event (scale-out, canary)."""
        models = self.current_models() if models is None else models
        version = self.tier.target_version(models)
        rep = self.manager.spawn(models, version, kind=kind)
        with self._lock:
            self._reps[rep.replica_id] = rep
        host = getattr(rep, "host", "127.0.0.1")
        self.balancer.add_replica(rep.replica_id, host,
                                  rep.http_port, rep.binary_port,
                                  version, kind=kind)
        if self.registry is not None:
            self.registry.upsert(endpoint_entry(
                rep.replica_id, "replica", host, rep.http_port,
                rep.binary_port, version=version, kind=kind,
                pid=rep.pid))
        self._emit_scale("replica_ready",
                         "replica %s (pid %d) serving %s"
                         % (rep.replica_id, rep.pid, version))
        return rep

    def retire_replica(self, rep: ReplicaProcess,
                       action: str = "scale_in") -> None:
        """Zero-drop scale-in: deroute, wait for in-flight forwards,
        then graceful-stop the process (its serve_fleet loop drains
        its own queues on SIGTERM)."""
        if self.registry is not None:
            # external doors learn the drain from the registry before
            # the process goes away — same zero-drop order, tier-wide
            self.registry.set_draining(rep.replica_id, True)
        drained = self.balancer.drain_replica(rep.replica_id)
        drained = self._await_external_drain(rep.replica_id) \
            and drained
        self.balancer.remove_replica(rep.replica_id)
        if self.registry is not None:
            self.registry.remove(rep.replica_id)
        self.manager.stop(rep)
        with self._lock:
            self._reps.pop(rep.replica_id, None)
        self._emit_scale(action,
                         "replica %s retired (drained=%s)"
                         % (rep.replica_id, drained))

    def _emit(self, kind: str, **fields) -> None:
        # telemetry failure must not fail scaling; SafeEmitter owns
        # the warn-once latch
        self._safe_emit(kind, **fields)

    def _emit_scale(self, action: str, reason: str, **fields) -> None:
        if self.bal_manager is not None:
            fields.setdefault(
                "balancers", 1 + len(self.bal_manager.balancers()))
        self._emit("fleet_scale", action=action,
                   replicas=len(self.manager.replicas()),
                   ready=self.ready_count(), reason=reason,
                   **fields)

    # -- sharded front tier (fleet_balancers > 1) --------------------------

    def _register_door0(self) -> None:
        if self.registry is not None:
            self.registry.upsert(endpoint_entry(
                self.balancer.balancer_id, "balancer", self.tier.host,
                self.balancer.http_port, self.balancer.binary_port))

    def _sync_door_peers(self) -> None:
        """Point the in-process door at the external doors (external
        doors learn their peers from the registry instead)."""
        if self.bal_manager is None:
            return
        self.balancer.set_tier_peers(
            [(b.balancer_id, b.host, b.http_port)
             for b in self.bal_manager.balancers()])

    def _spawn_door(self, index: int) -> None:
        bal = self.bal_manager.spawn(index)
        if self.registry is not None:
            self.registry.upsert(endpoint_entry(
                bal.balancer_id, "balancer", bal.host, bal.http_port,
                bal.binary_port, pid=bal.pid))
        self._sync_door_peers()
        self._emit_scale("balancer_ready",
                         "balancer %s (pid %d) serving"
                         % (bal.balancer_id, bal.pid))

    def _fetch_json(self, host: str, port: int,
                    path: str) -> Optional[Dict[str, Any]]:
        try:
            conn = http.client.HTTPConnection(host, port, timeout=5.0)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return json.loads(resp.read())
            finally:
                conn.close()
        except (OSError, ValueError):
            return None

    def _await_external_drain(self, rid: str,
                              timeout_s: float = 30.0) -> bool:
        """Wait until every external door has SEEN the drain (its
        registry sync applied the flag, or the replica left its table)
        and has no in-flight forwards to the victim. An unreachable
        door does not block a retire — its own self-heal handles it."""
        if self.bal_manager is None:
            return True
        deadline = time.monotonic() + timeout_s
        for bal in self.bal_manager.balancers():
            while time.monotonic() < deadline:
                snap = self._fetch_json(bal.host, bal.http_port,
                                        "/healthz")
                if snap is None:
                    break
                row = next((r for r in snap.get("replicas", [])
                            if r.get("replica") == rid), None)
                if row is None or (row.get("draining")
                                   and not row.get("inflight")):
                    break
                time.sleep(0.05)
            else:
                return False
        return True

    def front_doors(self) -> List[Dict[str, Any]]:
        """Every door of the tier as ``(id, host, http, binary)``
        descriptors — b0 in-process plus the spawned doors; what the
        bench and clients iterate for failover endpoints."""
        doors = [{"id": self.balancer.balancer_id,
                  "host": self.tier.host,
                  "http_port": self.balancer.http_port,
                  "binary_port": self.balancer.binary_port}]
        if self.bal_manager is not None:
            doors += [{"id": b.balancer_id, "host": b.host,
                       "http_port": b.http_port,
                       "binary_port": b.binary_port}
                      for b in self.bal_manager.balancers()]
        return doors

    # -- startup / shutdown ------------------------------------------------

    def start(self) -> None:
        self.balancer.start()
        self._register_door0()
        for _ in range(self.tier.replicas):
            self.spawn_replica()                 # SpawnError is fatal here
        if self.bal_manager is not None:
            for i in range(1, self.tier.balancers):
                self._spawn_door(i)              # SpawnError fatal too
        if self.canary is not None:
            self.canary.arm()
        self._scale_thread = threading.Thread(
            target=self._scale_loop, name="fleet-scale", daemon=True)
        self._scale_thread.start()

    def close(self) -> Dict[str, Any]:
        self._stop.set()
        if self._scale_thread is not None:
            self._scale_thread.join(timeout=60)
        if self.bal_manager is not None:
            # doors first: their in-flight forwards drain into the
            # replicas, which are still up to answer them
            for bal in self.bal_manager.balancers():
                if self.registry is not None:
                    self.registry.remove(bal.balancer_id)
                self.bal_manager.stop(bal)
            self.bal_manager.close()
        with self._lock:
            reps = list(self._reps.values())
        for rep in reps:
            self.retire_replica(rep, action="shutdown")
        self.manager.close()
        summary = self.balancer.close()
        if self.registry is not None:
            self.registry.remove(self.balancer.balancer_id)
        if self.canary is not None:
            summary["canary"] = self.canary.state
        return summary

    # -- the scale loop ----------------------------------------------------

    def _scale_loop(self) -> None:
        while not self._stop.wait(self.tier.scale_interval_s):
            try:
                self._tick()
            except Exception as e:
                # a scaling bug must not kill the loop that also does
                # self-healing; record it and keep ticking
                self._emit_scale("tick_error", "scale tick failed: %s"
                                 % e)

    def _tick(self, stats: Optional[Dict[str, Any]] = None) -> None:
        """One controller step; ``stats`` is injectable for tests
        (defaults to draining the balancer's live window)."""
        self._reap_dead()
        if self.canary is not None:
            self.canary.step()
        if stats is None:
            stats = self._take_fleet_window()
        state, reason = classify_load(stats, self.tier)
        now = time.monotonic()
        self._overload_since = (self._overload_since or now) \
            if state == "overload" else None
        self._idle_since = (self._idle_since or now) \
            if state == "idle" else None
        baseline = self.ready_count(kind="baseline")
        if state == "overload" \
                and now - self._overload_since \
                >= self.tier.scale_up_after_s:
            if baseline < self.tier.max_replicas:
                self._overload_since = None
                try:
                    self.spawn_replica()
                except SpawnError as e:
                    self._emit_scale("spawn_failed", str(e))
                else:
                    self._emit_scale("scale_out", reason, **{
                        k: stats[k] for k in
                        ("queue_rows", "shed", "p99_ms")
                        if k in stats})
        elif state == "idle" \
                and now - self._idle_since \
                >= self.tier.scale_down_after_s:
            if baseline > self.tier.min_replicas:
                self._idle_since = None
                victim = self._scale_in_victim()
                if victim is not None:
                    self.retire_replica(victim)

    def _take_fleet_window(self) -> Dict[str, Any]:
        """The autoscaler's input across the whole front tier: the
        in-process door's window plus one destructive
        ``GET /fleet/window`` per external door (this controller is
        the only window reader, by contract)."""
        windows = [self.balancer.take_window()]
        if self.bal_manager is not None:
            for bal in self.bal_manager.balancers():
                w = self._fetch_json(bal.host, bal.http_port,
                                     "/fleet/window")
                if w is not None:
                    windows.append(w)
        if len(windows) == 1:
            return windows[0]
        return aggregate_windows(windows)

    def _reap_dead(self) -> None:
        """Deroute crashed replicas, reap alive-but-wedged ones, then
        self-heal below the minimum."""
        if self.bal_manager is not None:
            # a dead front door loses no requests (clients fail over),
            # but the tier must heal back to fleet_balancers doors
            for bal in self.bal_manager.poll_dead():
                if self.registry is not None:
                    self.registry.remove(bal.balancer_id)
                self._sync_door_peers()
                self._emit_scale(
                    "balancer_lost",
                    "balancer %s (pid %d) exited with %s"
                    % (bal.balancer_id, bal.pid,
                       bal.proc.returncode))
                if not self._stop.is_set():
                    try:
                        self._spawn_door(bal.index)
                    except SpawnError as e:
                        self._emit_scale("spawn_failed", str(e))
        if self.tier.wedged_after_s > 0:
            # a process that is alive but unresponsive (deadlock,
            # swap-death) never shows up in poll_dead — without this
            # it would hold a fleet slot forever while serving nothing
            for rid in self.balancer.suspect_overdue(
                    self.tier.wedged_after_s):
                with self._lock:
                    rep = self._reps.get(rid)
                if rep is None:
                    continue
                self._deregister(rid)
                self.manager.stop(rep, timeout_s=5.0)
                with self._lock:
                    self._reps.pop(rid, None)
                self._emit_scale(
                    "replica_lost",
                    "replica %s wedged: suspect for over "
                    "fleet_wedged_after_s (%.0fs), force-stopped"
                    % (rid, self.tier.wedged_after_s))
                if self.canary is not None and rep.kind == "canary":
                    self.canary.canary_died(rep)
        for rep in self.manager.poll_dead():
            self._deregister(rep.replica_id)
            with self._lock:
                self._reps.pop(rep.replica_id, None)
            self._emit_scale("replica_lost",
                             "replica %s (pid %d) exited with %s"
                             % (rep.replica_id, rep.pid,
                                rep.proc.returncode
                                if hasattr(rep, "proc") else "?"))
            if self.canary is not None and rep.kind == "canary":
                self.canary.canary_died(rep)
        while self.ready_count(kind="baseline") \
                < self.tier.min_replicas and not self._stop.is_set():
            try:
                self.spawn_replica()
            except SpawnError as e:
                self._emit_scale("spawn_failed", str(e))
                break

    def _deregister(self, rid: str) -> None:
        """Deroute a lost replica here and, with a registry, for the
        external doors and failover clients too (the reference leaves a
        lost replica's registry entry behind)."""
        self.balancer.remove_replica(rid)
        if self.registry is not None:
            self.registry.remove(rid)

    def _scale_in_victim(self) -> Optional[ReplicaProcess]:
        """Newest ready baseline replica — canary replicas are the
        rollout's to manage, and the oldest replicas have the warmest
        page caches."""
        ids = set(self.balancer.replica_ids(kind="baseline"))
        with self._lock:
            cands = [r for r in self._reps.values()
                     if r.replica_id in ids]
        return max(cands, key=lambda r: r.replica_id, default=None)
