"""Canary rollout: pin a traffic fraction to a new bundle version,
compare, promote or roll back — automatically (counterpart of
``cxxnet_tpu/fleet/canary.py``).

Armed by ``canary_source`` (a new sealed bundle / snapshot for the
``canary_model`` entry), the rollout:

1. spawns one canary replica serving the new version and pins
   ``canary_fraction`` of balancer traffic to it (deterministic
   interleave — no RNG, reproducible splits);
2. observes per-version outcome/latency windows for
   ``canary_window_s`` (the balancer resets both windows at pin time,
   so baseline and canary are measured over the same period under the
   same traffic);
3. decides via the pure :func:`canary_decision`: the canary must not
   raise the error rate beyond ``canary_max_error_rate`` over
   baseline, nor stretch ok-request p99 beyond ``canary_p99_ratio`` x
   baseline, with at least ``canary_min_requests`` canary samples;
4. **promote** — the controller's current model set repoints at the
   new version; baseline replicas are rolled one at a time
   (spawn-new -> drain-old -> stop, never dropping below the serving
   count) and the canary replica joins the baseline pool; or
   **rollback** — the canary replica drains and stops, the good
   version keeps serving. A canary replica that dies or fails to boot
   (the injected-bad-bundle case) rolls back immediately.

Every phase emits a schema-validated ``canary`` record; the
promote/rollback record doubles as the decision record written to
``canary_out`` (default ``<fleet_dir>/canary_decision.json``) after
:func:`~cxxnet_tpu_torch.monitor.schema.validate_record` passes on it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..monitor import SafeEmitter
from ..monitor.schema import validate_record
from .config import FleetTierConfig, version_of
from .replica import SpawnError


def canary_decision(base: Dict[str, Any], cane: Dict[str, Any],
                    tier: FleetTierConfig) -> Tuple[str, str]:
    """Pure comparison of two per-version stat windows
    (``{"ok", "errors", "requests", "p99_ms"}``):
    ``("promote" | "rollback" | "wait", reason)``.

    Not enough canary samples -> wait. A canary error rate more than
    ``canary_max_error_rate`` above baseline's, or an ok-request p99
    beyond ``canary_p99_ratio`` x baseline's (when baseline has a
    meaningful p99), rolls back; otherwise promote."""
    n_c = int(cane.get("requests", 0))
    if n_c < tier.canary_min_requests:
        return "wait", ("canary has %d/%d required requests"
                        % (n_c, tier.canary_min_requests))
    err_c = cane.get("errors", 0) / float(n_c)
    n_b = int(base.get("requests", 0))
    err_b = base.get("errors", 0) / float(n_b) if n_b else 0.0
    if err_c > err_b + tier.canary_max_error_rate:
        return "rollback", (
            "canary error rate %.4f exceeds baseline %.4f + "
            "canary_max_error_rate %.4f"
            % (err_c, err_b, tier.canary_max_error_rate))
    p99_b = float(base.get("p99_ms", 0.0))
    p99_c = float(cane.get("p99_ms", 0.0))
    if p99_b > 0 and cane.get("ok", 0) \
            and p99_c > tier.canary_p99_ratio * p99_b:
        return "rollback", (
            "canary p99 %.1f ms exceeds %.2fx baseline p99 %.1f ms"
            % (p99_c, tier.canary_p99_ratio, p99_b))
    return "promote", (
        "canary error rate %.4f (baseline %.4f), p99 %.1f ms "
        "(baseline %.1f ms) within thresholds"
        % (err_c, err_b, p99_c, p99_b))


class CanaryRollout:
    """One-shot canary driven by the controller's scale loop
    (``step()`` per tick). States: ``armed`` -> ``observing`` ->
    ``promoted`` | ``rolled_back``."""

    def __init__(self, controller, tier: FleetTierConfig,
                 monitor=None):
        self.controller = controller
        self.tier = tier
        self._safe_emit = SafeEmitter(monitor, "cxxnet_tpu_torch canary")
        self._lock = threading.Lock()
        self.state = "armed"
        self.canary_version = version_of(tier.canary_source)
        self.baseline_version = ""
        self._rep = None                     # the canary replica
        self._observe_t0 = 0.0
        self.decision: Optional[Dict[str, Any]] = None

    # -- state machine -----------------------------------------------------

    def arm(self) -> None:
        """Spawn the canary replica and pin the traffic fraction;
        a boot failure (bad bundle: refuses to load, over budget,
        crashes during warmup) rolls back immediately — the injected-
        bad-bundle path."""
        self.baseline_version = self.controller.current_version()
        if self.canary_version == self.baseline_version:
            self._finish("rollback",
                         "canary_source is already the serving "
                         "version", {}, {})
            return
        models = self.tier.models_with_source(self.tier.canary_source)
        try:
            self._rep = self.controller.spawn_replica(models=models,
                                                      kind="canary")
        except SpawnError as e:
            self._finish("rollback",
                         "canary replica failed to boot: %s" % e,
                         {}, {})
            return
        self.controller.balancer.pin_canary(self.canary_version,
                                            self.tier.canary_fraction)
        with self._lock:
            self.state = "observing"
            self._observe_t0 = time.monotonic()
        self._phase_record(
            "start", "observing %s at fraction %g for %gs"
            % (self.canary_version, self.tier.canary_fraction,
               self.tier.canary_window_s), {}, {})

    def step(self) -> None:
        """One controller tick: decide once the window has elapsed
        (and keep waiting for samples up to 3 windows — a canary that
        cannot accumulate ``canary_min_requests`` in that long has no
        evidence either way, and an unobserved version must not be
        promoted)."""
        with self._lock:
            if self.state != "observing":
                return
            elapsed = time.monotonic() - self._observe_t0
        if elapsed < self.tier.canary_window_s:
            return
        stats = self.controller.balancer.version_stats()
        base = stats.get(self.baseline_version, {})
        cane = stats.get(self.canary_version, {})
        verdict, reason = canary_decision(base, cane, self.tier)
        if verdict == "wait":
            if elapsed < 3 * self.tier.canary_window_s:
                return
            verdict, reason = "rollback", (
                "insufficient canary traffic after %.0fs: %s"
                % (elapsed, reason))
        if verdict == "promote":
            self._promote(reason, base, cane)
        else:
            self._rollback(reason, base, cane)

    def canary_died(self, rep) -> None:
        """Controller noticed the canary process exited: the strongest
        possible rollback signal."""
        with self._lock:
            if self.state != "observing":
                return
            self._rep = None
        stats = self.controller.balancer.version_stats()
        self._rollback("canary replica %s died mid-window"
                       % rep.replica_id,
                       stats.get(self.baseline_version, {}),
                       stats.get(self.canary_version, {}))

    # -- outcomes ----------------------------------------------------------

    def _promote(self, reason: str, base: Dict, cane: Dict) -> None:
        """Repoint the fleet at the new version and roll the old
        baseline replicas one at a time — spawn-before-retire, so the
        serving count never dips."""
        ctl = self.controller
        new_models = self.tier.models_with_source(
            self.tier.canary_source)
        ctl.set_current_models(new_models)
        old = [r for r in ctl.manager.replicas()
               if r.version == self.baseline_version]
        for rep in old:
            try:
                ctl.spawn_replica()          # now spawns the new version
            except SpawnError as e:
                # promote already decided on measured evidence; a
                # failed roll spawn leaves the old replica serving
                ctl._emit_scale("spawn_failed",
                                "promote roll: %s" % e)
                break
            ctl.retire_replica(rep, action="promote_roll")
        # the canary replica is now just a baseline of the new version
        if self._rep is not None:
            self._rep.kind = "baseline"
            ctl.balancer.set_replica_kind(self._rep.replica_id,
                                          "baseline")
        ctl.balancer.unpin_canary()
        self._finish("promote", reason, base, cane)

    def _rollback(self, reason: str, base: Dict, cane: Dict) -> None:
        ctl = self.controller
        ctl.balancer.unpin_canary()
        rep = self._rep
        self._rep = None
        if rep is not None and rep.alive():
            ctl.retire_replica(rep, action="canary_rollback")
        self._finish("rollback", reason, base, cane)

    def _finish(self, phase: str, reason: str, base: Dict,
                cane: Dict) -> None:
        with self._lock:
            self.state = "promoted" if phase == "promote" \
                else "rolled_back"
        self.decision = self._phase_record(phase, reason, base, cane)
        self._write_decision(self.decision)

    # -- records -----------------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        self._safe_emit(kind, **fields)

    def _phase_record(self, phase: str, reason: str, base: Dict,
                      cane: Dict) -> Dict[str, Any]:
        rec = {
            "event": "canary", "t": time.time(), "phase": phase,
            "baseline_version": self.baseline_version,
            "canary_version": self.canary_version,
            "fraction": self.tier.canary_fraction,
            "reason": reason,
            "window_s": self.tier.canary_window_s,
            "baseline": dict(base), "canary": dict(cane),
        }
        errs = validate_record(rec)
        assert not errs, "canary decision record invalid: %s" % errs
        fields = dict(rec)
        fields.pop("event")
        fields.pop("t")
        self._emit("canary", **fields)
        return rec

    def _write_decision(self, rec: Dict[str, Any]) -> None:
        """The decision record file operators and deploy tooling read
        (atomic tmp+rename; schema-validated above)."""
        out = self.tier.canary_out or os.path.join(
            self.tier.fleet_dir, "canary_decision.json")
        d = os.path.dirname(os.path.abspath(out))
        os.makedirs(d, exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, sort_keys=True, indent=1)
        os.replace(tmp, out)
