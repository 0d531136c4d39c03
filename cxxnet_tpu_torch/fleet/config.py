"""Parsed configuration for the horizontal fleet tier (counterpart of
``cxxnet_tpu/fleet/config.py``: the same keys, defaults and checks).

One place turns the ordered ``(name, value)`` config stream into the
knobs the balancer, autoscale controller, and canary rollout share
(``task = fleet``, the reference's doc/serving.md "Horizontal fleet"). Grammar:

- ``fleet_*`` keys size and tune the tier (replica bounds, listener
  ports, health/scale cadence, load thresholds);
- ``canary_*`` keys arm a one-shot canary rollout of a new bundle
  version;
- the replicas themselves are configured by the SAME ``serve_*`` keys
  as a standalone ``task = serve_fleet`` process — the controller
  passes the config file through and appends per-replica overrides
  (ephemeral ports, port file, pinned model sources, quotas stripped).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from ..serve.frontend import FleetConfig

# one model entry: (model_id, source, bucket_override)
ModelEntry = Tuple[str, str, str]


def version_of(source: str) -> str:
    """Human-readable version label for a model source — the basename
    (``0002.model.bundle``) keeps bundle counters visible in telemetry
    and the canary decision record."""
    base = os.path.basename(str(source).rstrip("/"))
    return base or str(source)


def models_spec(entries: Sequence[ModelEntry]) -> str:
    """Re-assemble ``serve_models`` grammar from parsed entries (the
    inverse of ``FleetConfig._parse_models``): ``;``-separated when any
    entry carries a bucket ladder (ladders are comma lists), ``,``
    otherwise."""
    parts = ["%s=%s|%s" % (m, s, b) if b else "%s=%s" % (m, s)
             for m, s, b in entries]
    return ";".join(parts) if any(b for _, _, b in entries) \
        else ",".join(parts)


class FleetTierConfig:
    """Parsed ``fleet_*`` / ``canary_*`` keys (the reference's doc/serving.md
    "Horizontal fleet" has the full table)."""

    def __init__(self, cfg: Sequence):
        self.replicas = 1
        self.min_replicas = 0          # 0 -> fleet_replicas
        self.max_replicas = 0          # 0 -> max(fleet_replicas, 4)
        self.http_port = 0
        self.binary_port = 0
        self.host = "127.0.0.1"
        self.fleet_dir = "./fleet_run"
        self.source = ""
        self.health_poll_s = 0.5
        self.unhealthy_after = 2
        self.wedged_after_s = 30.0
        self.retries = 3
        self.channels_per_replica = 2
        self.coalesce_ms = 0.0
        self.coalesce_rows = 256
        self.spawn_timeout_s = 180.0
        self.scale_interval_s = 1.0
        self.scale_up_after_s = 2.0
        self.scale_down_after_s = 10.0
        self.queue_hi = 1.0
        self.queue_lo = 0.05
        self.shed_hi = 0.02
        self.slo_p99_ms = 0.0
        self.duration_s = 0.0
        self.canary_source = ""
        self.canary_model = ""
        self.canary_fraction = 0.1
        self.canary_window_s = 30.0
        self.canary_min_requests = 50
        self.canary_max_error_rate = 0.02
        self.canary_p99_ratio = 1.5
        self.canary_out = ""
        self.balancers = 1
        self.balancer_id = ""
        self.balancer_index = 0
        self.gossip_s = 0.5
        self.quota_rebalance_s = 2.0
        self.launcher = "local"
        self.hosts: List[str] = []
        self.registry = ""
        self.port_file = ""
        models_val = ""
        model_dir, model_in = "", ""
        for name, val in cfg:
            if name == "fleet_balancers":
                self.balancers = int(val)
            if name == "fleet_balancer_id":
                self.balancer_id = val
            if name == "fleet_balancer_index":
                self.balancer_index = int(val)
            if name == "fleet_gossip_s":
                self.gossip_s = float(val)
            if name == "fleet_quota_rebalance_s":
                self.quota_rebalance_s = float(val)
            if name == "fleet_launcher":
                self.launcher = val
            if name == "fleet_hosts":
                self.hosts = [h.strip() for h in val.split(",")
                              if h.strip()]
            if name == "fleet_registry":
                self.registry = val
            if name == "fleet_port_file":
                self.port_file = val
            if name == "fleet_replicas":
                self.replicas = int(val)
            if name == "fleet_min_replicas":
                self.min_replicas = int(val)
            if name == "fleet_max_replicas":
                self.max_replicas = int(val)
            if name == "fleet_http_port":
                self.http_port = int(val)
            if name == "fleet_binary_port":
                self.binary_port = int(val)
            if name == "fleet_host":
                self.host = val
            if name == "fleet_dir":
                self.fleet_dir = val
            if name == "fleet_source":
                self.source = val
            if name == "fleet_health_poll_s":
                self.health_poll_s = float(val)
            if name == "fleet_unhealthy_after":
                self.unhealthy_after = int(val)
            if name == "fleet_wedged_after_s":
                self.wedged_after_s = float(val)
            if name == "fleet_retries":
                self.retries = int(val)
            if name == "fleet_channels_per_replica":
                self.channels_per_replica = int(val)
            if name == "fleet_coalesce_ms":
                self.coalesce_ms = float(val)
            if name == "fleet_coalesce_rows":
                self.coalesce_rows = int(val)
            if name == "fleet_spawn_timeout_s":
                self.spawn_timeout_s = float(val)
            if name == "fleet_scale_interval_s":
                self.scale_interval_s = float(val)
            if name == "fleet_scale_up_after_s":
                self.scale_up_after_s = float(val)
            if name == "fleet_scale_down_after_s":
                self.scale_down_after_s = float(val)
            if name == "fleet_queue_hi":
                self.queue_hi = float(val)
            if name == "fleet_queue_lo":
                self.queue_lo = float(val)
            if name == "fleet_shed_hi":
                self.shed_hi = float(val)
            if name == "fleet_slo_p99_ms":
                self.slo_p99_ms = float(val)
            if name == "fleet_duration_s":
                self.duration_s = float(val)
            if name == "canary_source":
                self.canary_source = val
            if name == "canary_model":
                self.canary_model = val
            if name == "canary_fraction":
                self.canary_fraction = float(val)
            if name == "canary_window_s":
                self.canary_window_s = float(val)
            if name == "canary_min_requests":
                self.canary_min_requests = int(val)
            if name == "canary_max_error_rate":
                self.canary_max_error_rate = float(val)
            if name == "canary_p99_ratio":
                self.canary_p99_ratio = float(val)
            if name == "canary_out":
                self.canary_out = val
            if name == "serve_models":
                models_val = val
            if name == "model_dir":
                model_dir = val
            if name == "model_in":
                model_in = val
        if self.replicas < 1:
            raise ValueError("fleet_replicas must be >= 1")
        if self.channels_per_replica < 0:
            raise ValueError(
                "fleet_channels_per_replica must be >= 0 "
                "(0 = pooled v1 data path)")
        if self.coalesce_ms < 0:
            raise ValueError("fleet_coalesce_ms must be >= 0")
        if self.coalesce_rows < 1:
            raise ValueError("fleet_coalesce_rows must be >= 1")
        if not self.min_replicas:
            self.min_replicas = self.replicas
        if not self.max_replicas:
            self.max_replicas = max(self.replicas, 4)
        if not (self.min_replicas <= self.replicas
                <= self.max_replicas):
            raise ValueError(
                "fleet replica bounds must satisfy min (%d) <= "
                "initial (%d) <= max (%d)"
                % (self.min_replicas, self.replicas,
                   self.max_replicas))
        if not 0.0 < self.canary_fraction < 1.0:
            raise ValueError(
                "canary_fraction must be in (0, 1), got %r"
                % self.canary_fraction)
        if self.balancers < 1:
            raise ValueError("fleet_balancers must be >= 1")
        if not 0 <= self.balancer_index < self.balancers:
            raise ValueError(
                "fleet_balancer_index must be in [0, %d), got %d"
                % (self.balancers, self.balancer_index))
        if not self.balancer_id:
            self.balancer_id = "b%d" % self.balancer_index
        if self.gossip_s <= 0:
            raise ValueError("fleet_gossip_s must be > 0")
        if self.quota_rebalance_s <= 0:
            raise ValueError("fleet_quota_rebalance_s must be > 0")
        if self.launcher not in ("local", "ssh"):
            raise ValueError(
                "fleet_launcher must be local or ssh, got %r"
                % self.launcher)
        if self.launcher == "ssh" and not self.hosts:
            raise ValueError("fleet_launcher=ssh needs fleet_hosts")
        if self.balancers > 1 and self.canary_source:
            # canary pinning routes a deterministic request fraction
            # through ONE door's rollout state; a sharded front tier
            # would need tier-wide canary accounting, which is out of
            # scope for now
            raise ValueError(
                "canary_source requires fleet_balancers=1 (canary "
                "accounting is single-door)")
        if self.http_port < 0 and self.binary_port < 0:
            raise ValueError(
                "fleet balancer with both protocols disabled serves "
                "nothing — enable fleet_http_port or "
                "fleet_binary_port")
        # the model set every replica serves: an explicit serve_models
        # spec passes through verbatim; otherwise one "default" model
        # over fleet_source (falling back to the model_in / model_dir
        # the rest of the system already uses)
        if models_val:
            self.models: List[ModelEntry] = \
                FleetConfig._parse_models(models_val)
        else:
            src = self.source or model_in or model_dir
            if not src:
                raise ValueError(
                    "fleet needs a model source: serve_models, "
                    "fleet_source, model_in, or model_dir")
            self.models = [("default", src, "")]
        if not self.canary_model:
            self.canary_model = self.models[0][0]
        if self.canary_source and self.canary_model not in \
                {m for m, _, _ in self.models}:
            raise ValueError(
                "canary_model %r is not a served model id (%s)"
                % (self.canary_model,
                   ", ".join(m for m, _, _ in self.models)))

    @property
    def registry_path(self) -> str:
        """The endpoint-registry file this fleet shares (explicit
        ``fleet_registry`` or ``<fleet_dir>/endpoints.json``)."""
        return self.registry or os.path.join(self.fleet_dir,
                                             "endpoints.json")

    def models_with_source(self, source: str) -> List[ModelEntry]:
        """The model set with the canary-target model's source replaced
        — what a canary replica serves, and what the whole fleet
        serves after a promote."""
        return [(m, source if m == self.canary_model else s, b)
                for m, s, b in self.models]

    def target_version(self, entries: Sequence[ModelEntry]) -> str:
        """Version label of the canary-target model within a model
        set."""
        for m, s, _ in entries:
            if m == self.canary_model:
                return version_of(s)
        return version_of(entries[0][1])
