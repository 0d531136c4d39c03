"""Replica processes: spawn, watch, drain, stop (counterpart of
``cxxnet_tpu/fleet/replica.py``).

A fleet replica is a **shared-nothing OS process** running the
existing ``task = serve_fleet`` front end (``serve/frontend.py``) over
its own engines — no cross-process collectives, no shared device
state: several replicas share one GPU, each with its own CUDA context.
A replica runs on the GPU unless ``dev = cpu`` reaches it (through the
config file or the fleet's CLI overrides); one that finds no GPU exits
before publishing its ports, and its spawn fails with
:class:`SpawnError` and the log tail. The manager spawns replicas
through the same CLI every deployment uses::

    python -m cxxnet_tpu_torch.main <conf> task=serve_fleet \
        serve_models=<pinned sources> serve_http_port=0 \
        serve_binary_port=0 serve_port_file=<fleet_dir>/<rid>.ports.json

and learns the ephemeral ports from the port file the replica commits
atomically after its listeners bind (``serve_port_file``). Replica
overrides pin model sources (version pins — fleet versioning is
controller-driven, so the per-replica hot-swap watcher is off), strip
tenant quotas (the balancer enforces them fleet-wide, before any
replica queue), and silence the replica monitor (the balancer's
stream is the fleet telemetry; replica accounting rides ``/healthz``).

Boot cost is why scale-out is cheap at all: replicas booting from a
sealed bundle (``artifact/bundle.py``) install its kernel libraries
instead of running ``nvcc``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from .config import FleetTierConfig, ModelEntry, models_spec
from .placement import Launcher, LocalLauncher


class SpawnError(RuntimeError):
    """A replica process failed to come up (died or timed out before
    publishing its ports); carries the tail of the replica log."""


def _log_tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - n))
            return f.read().decode(errors="replace")
    except OSError:
        return "<replica log unreadable>"


class ReplicaProcess:
    """One spawned replica: the OS process plus what the balancer
    needs to route to it (host/ports) and what the controller needs to
    manage it (kind, version, model sources)."""

    def __init__(self, replica_id: str, proc: subprocess.Popen,
                 models: Sequence[ModelEntry], version: str,
                 kind: str, port_file: str, log_path: str,
                 host: str = "127.0.0.1"):
        self.replica_id = replica_id
        self.proc = proc
        self.models = list(models)
        self.version = version
        self.kind = kind                     # "baseline" | "canary"
        self.port_file = port_file
        self.log_path = log_path
        self.host = host
        self.http_port = 0
        self.binary_port = 0
        self.stopped = False                 # stopped BY the manager

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None


class ReplicaManager:
    """Spawn/stop fleet replicas as child processes of this host.

    Thread discipline: the controller's scale thread calls
    ``spawn``/``stop``/``poll_dead`` while ``close`` may run on the
    main thread — the replica table is lock-guarded.
    """

    def __init__(self, conf_path: str, tier: FleetTierConfig,
                 extra_overrides: Sequence[str] = (),
                 launcher: Optional[Launcher] = None):
        self.conf_path = conf_path
        self.tier = tier
        # overrides every replica inherits (e.g. the CLI overrides the
        # operator passed to task=fleet, minus the fleet-only keys)
        self.extra_overrides = list(extra_overrides)
        # where replica processes run: local Popen by default; the
        # placement layer (fleet/placement.py) swaps in cross-machine
        # launchers behind the same CLI + port-file contract
        self.launcher = launcher or LocalLauncher()
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaProcess] = {}
        self._seq = 0
        self._closed = False
        os.makedirs(tier.fleet_dir, exist_ok=True)

    # -- spawn ------------------------------------------------------------

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return "r%03d" % self._seq

    def _command(self, rid: str, models: Sequence[ModelEntry],
                 port_file: str) -> List[str]:
        overrides = [
            "task=serve_fleet",
            "serve_models=%s" % models_spec(models),
            "serve_http_port=0",
            "serve_binary_port=0",
            "serve_host=%s" % self.launcher.host(),
            "serve_port_file=%s" % port_file,
            # fleet versioning is controller-driven (canary rollout /
            # promote): the per-replica snapshot watcher must not race
            # it by swapping sources underneath the balancer's
            # version accounting
            "serve_swap_poll_s=0",
            "serve_fleet_duration_s=0",
            # quotas are enforced fleet-wide at the balancer, BEFORE
            # any replica queue — a replica-level second enforcement
            # would shed admitted traffic
            "serve_quota=",
            "serve_quota_default=",
            # the balancer's stream is the fleet telemetry; a shared
            # monitor_path across replicas would interleave corruptly
            "monitor=none",
        ]
        return ([sys.executable, "-m", "cxxnet_tpu_torch.main",
                 self.conf_path] + self.extra_overrides + overrides)

    def spawn(self, models: Sequence[ModelEntry], version: str,
              kind: str = "baseline") -> ReplicaProcess:
        """Start one replica over ``models`` and block until it
        publishes its ports (listeners bound, engines warmed) or dies;
        raises :class:`SpawnError` with the log tail on failure."""
        rid = self._next_id()
        port_file = os.path.join(self.tier.fleet_dir,
                                 "%s.ports.json" % rid)
        log_path = os.path.join(self.tier.fleet_dir, "%s.log" % rid)
        if os.path.exists(port_file):
            os.remove(port_file)
        proc = self.launcher.launch(
            self._command(rid, models, port_file), log_path)
        rep = ReplicaProcess(rid, proc, models, version, kind,
                             port_file, log_path,
                             host=self.launcher.host())
        deadline = time.monotonic() + self.tier.spawn_timeout_s
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise SpawnError(
                    "replica %s (pid %d) exited with code %s before "
                    "publishing ports; log tail:\n%s"
                    % (rid, proc.pid, proc.returncode,
                       _log_tail(log_path)))
            if os.path.exists(port_file):
                with open(port_file) as f:
                    ports = json.load(f)
                rep.http_port = int(ports["http_port"])
                rep.binary_port = int(ports["binary_port"])
                with self._lock:
                    if self._closed:
                        # the fleet shut down while this replica was
                        # booting: registering it would leak a process
                        # nothing will ever stop
                        closed = True
                    else:
                        closed = False
                        self._replicas[rid] = rep
                if closed:
                    proc.terminate()
                    proc.wait()
                    raise SpawnError(
                        "replica %s came up after the manager closed; "
                        "stopped" % rid)
                return rep
            time.sleep(0.05)
        proc.kill()
        proc.wait()
        raise SpawnError(
            "replica %s (pid %d) timed out after %.0fs waiting for "
            "ports; log tail:\n%s"
            % (rid, proc.pid, self.tier.spawn_timeout_s,
               _log_tail(log_path)))

    # -- lifecycle --------------------------------------------------------

    def replicas(self) -> List[ReplicaProcess]:
        with self._lock:
            return list(self._replicas.values())

    def poll_dead(self) -> List[ReplicaProcess]:
        """Replicas that died WITHOUT the manager stopping them (a
        crash / OOM-kill / operator kill): removed from the table and
        returned so the controller can deroute and self-heal."""
        dead = []
        with self._lock:
            for rid in list(self._replicas):
                rep = self._replicas[rid]
                if not rep.stopped and not rep.alive():
                    dead.append(rep)
                    del self._replicas[rid]
        return dead

    def stop(self, rep: ReplicaProcess,
             timeout_s: float = 30.0) -> Optional[int]:
        """Graceful stop: SIGTERM (the replica's serve_fleet loop
        drains its engines and exits), escalate to SIGKILL after
        ``timeout_s``. Returns the exit code."""
        with self._lock:
            rep.stopped = True
            self._replicas.pop(rep.replica_id, None)
        if rep.alive():
            rep.proc.terminate()
            try:
                rep.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait()
        return rep.proc.returncode

    def close(self) -> None:
        with self._lock:
            self._closed = True
        for rep in self.replicas():
            self.stop(rep)
