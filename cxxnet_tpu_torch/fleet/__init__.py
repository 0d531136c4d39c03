"""Horizontal fleet: replica balancer, telemetry-driven autoscale,
canary rollout (``task = fleet``; counterpart of ``cxxnet_tpu/fleet/``,
the reference's doc/serving.md "Horizontal fleet").

The tier above the serve core that turns N shared-nothing
``serve_fleet`` replica **processes** into one elastic, self-healing
service:

- :mod:`~cxxnet_tpu_torch.fleet.balancer` — front-of-fleet routing over
  both existing protocols: load-aware health (enriched ``/healthz``),
  idempotent retry across a replica loss (zero dropped requests),
  fleet-wide tenant quotas, canary traffic pinning;
- :mod:`~cxxnet_tpu_torch.fleet.replica` — replica process lifecycle:
  spawn through the standard CLI, learn ephemeral ports via
  ``serve_port_file``, graceful drain/stop;
- :mod:`~cxxnet_tpu_torch.fleet.controller` — the autoscaler: classify
  load from the balancer's telemetry window (queue depth, shed rate,
  p99 vs SLO), scale out from the same sealed bundle (near-zero cold
  start is what makes elasticity cheap), drain in at idle, self-heal
  crashed replicas;
- :mod:`~cxxnet_tpu_torch.fleet.canary` — one-shot canary rollout: pin a
  fraction, compare per-version windows, promote or roll back with a
  schema-validated decision record;
- :mod:`~cxxnet_tpu_torch.fleet.placement` — where processes run: the
  ``Launcher`` seam behind the spawn path (local Popen today, ssh
  with the same CLI + port-file contract tomorrow) and the
  endpoint-registry file that generalizes per-replica port files
  (the reference's doc/serving.md "Sharded front tier");
- :mod:`~cxxnet_tpu_torch.fleet.quota_shares` — distributed tenant quotas:
  the fleet rate decomposed into per-door budget shares, rebalanced
  toward observed demand over gossip.
"""

from .balancer import (FleetBalancer, ReplicaChannel, ReplicaState,
                       ReplicaUnreachable, ReplicaV1Only)
from .canary import CanaryRollout, canary_decision
from .config import FleetTierConfig, models_spec, version_of
from .controller import (FleetController, aggregate_windows,
                         classify_load)
from .placement import (BalancerManager, BalancerProcess,
                        EndpointRegistry, Launcher, LocalLauncher,
                        PlacementError, SshLauncher, endpoint_entry,
                        make_launcher, sync_from_registry,
                        write_endpoint_file)
from .quota_shares import QuotaShareManager, compute_shares
from .replica import ReplicaManager, ReplicaProcess, SpawnError

__all__ = [
    "FleetBalancer", "ReplicaChannel", "ReplicaState",
    "ReplicaUnreachable", "ReplicaV1Only",
    "CanaryRollout", "canary_decision", "FleetTierConfig",
    "models_spec", "version_of", "FleetController",
    "aggregate_windows", "classify_load",
    "BalancerManager", "BalancerProcess", "EndpointRegistry",
    "Launcher", "LocalLauncher", "PlacementError", "SshLauncher",
    "endpoint_entry", "make_launcher", "sync_from_registry",
    "write_endpoint_file", "QuotaShareManager", "compute_shares",
    "ReplicaManager", "ReplicaProcess", "SpawnError",
]
