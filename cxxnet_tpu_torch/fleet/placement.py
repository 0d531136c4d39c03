"""Placement: launchers and the fleet endpoint registry (counterpart of
``cxxnet_tpu/fleet/placement.py``; the registry file is the same bytes).

Two abstractions move the fleet off "one box, hardcoded
``127.0.0.1``":

- :class:`Launcher` — how a fleet member process is started. The
  controller composes the SAME CLI command either way
  (``python -m cxxnet_tpu_torch.main <conf> task=... key=val ...``); the
  launcher decides where it runs. :class:`LocalLauncher` is
  ``subprocess.Popen`` on this host (the only launcher that starts
  processes); :class:`SshLauncher` wraps the identical argv in
  ``ssh <host>`` — the command contract is already remote-safe because
  discovery happens through files/ports, not pipes.

- :class:`EndpointRegistry` — one JSON file naming every fleet member
  (replicas AND balancers): id, role, host, ports, version, kind,
  draining. It generalizes the per-process ``*.ports.json`` port files:
  the controller is the single writer; balancer processes watch it
  (mtime) to learn replicas and tier peers; clients read it to get the
  balancer endpoint list for failover. Writes are atomic
  (tmp + ``os.replace``), same discipline as
  ``FleetServer._write_port_file``.

``task = fleet_balancer`` (main.py) is the spawn target for extra
front doors; :class:`BalancerManager` starts them with the same
port-file handshake replicas use.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from .config import FleetTierConfig


class PlacementError(RuntimeError):
    """A launcher cannot start processes where it was asked to."""


def write_endpoint_file(path: str, payload: Dict[str, object]) -> None:
    """Atomically commit a small JSON discovery file: readers see the
    old content or the new content, never a torn write."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# -- launchers ------------------------------------------------------------


class Launcher:
    """How fleet member processes start. ``launch`` returns a
    ``subprocess.Popen``-compatible handle (``pid``, ``poll``,
    ``terminate``, ``kill``, ``wait``); ``host`` is the address the
    spawned process is reachable at (its listeners bind there and the
    balancer/clients connect there)."""

    kind = "abstract"

    def host(self) -> str:
        raise NotImplementedError

    def launch(self, argv: Sequence[str],
               log_path: str) -> subprocess.Popen:
        raise NotImplementedError


class LocalLauncher(Launcher):
    """Spawn on this host via ``subprocess.Popen``, stdout+stderr to a
    log file, PYTHONPATH pinned to this checkout so the child imports
    the same cxxnet_tpu_torch (not a shadowing site-packages install)."""

    kind = "local"

    def host(self) -> str:
        return "127.0.0.1"

    def launch(self, argv: Sequence[str],
               log_path: str) -> subprocess.Popen:
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        with open(log_path, "ab") as logf:
            return subprocess.Popen(list(argv), stdout=logf,
                                    stderr=subprocess.STDOUT, env=env)


class SshLauncher(Launcher):
    """Cross-machine stub: the same CLI argv wrapped in ``ssh <host>``.

    The command contract is already machine-spread-safe — the child
    publishes its ports through a file on a path the controller can
    read (a shared filesystem in a real deployment) and serves on the
    host ``host()`` returns. Remote launch is not built, so ``launch``
    raises :class:`PlacementError`; ``command`` is the tested contract
    a remote deployment fills in.
    """

    kind = "ssh"

    def __init__(self, hosts: Sequence[str]):
        if not hosts:
            raise ValueError("ssh launcher needs fleet_hosts")
        self.hosts = list(hosts)
        self._next = 0

    def host(self) -> str:
        # round-robin placement over the host list; the host is chosen
        # at launch time and the same host is reported for discovery
        return self.hosts[self._next % len(self.hosts)]

    def command(self, argv: Sequence[str]) -> List[str]:
        target = self.host()
        return ["ssh", "-o", "BatchMode=yes", target,
                " ".join(shlex.quote(a) for a in argv)]

    def launch(self, argv: Sequence[str],
               log_path: str) -> subprocess.Popen:
        raise PlacementError(
            "ssh launcher is a placement stub in this build: would "
            "run %r" % (self.command(argv),))


def make_launcher(tier: FleetTierConfig) -> Launcher:
    """The launcher ``fleet_launcher`` names (default local)."""
    if tier.launcher == "ssh":
        return SshLauncher(tier.hosts)
    return LocalLauncher()


# -- endpoint registry ----------------------------------------------------


def endpoint_entry(member_id: str, role: str, host: str,
                   http_port: int, binary_port: int,
                   version: str = "", kind: str = "",
                   pid: int = 0,
                   draining: bool = False) -> Dict[str, object]:
    """One registry row. ``role`` is ``replica`` or ``balancer``."""
    return {"id": member_id, "role": role, "host": host,
            "http_port": int(http_port),
            "binary_port": int(binary_port),
            "version": version, "kind": kind, "pid": int(pid),
            "draining": bool(draining)}


class EndpointRegistry:
    """The fleet's shared discovery file.

    Single-writer (the controller — or the bench harness standing in
    for it), many readers. Readers cache on mtime so the balancer's
    sync loop costs a ``stat`` per poll, not a parse."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._cache: Dict[str, Dict[str, object]] = {}
        self._mtime: Optional[float] = None
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, entries: Sequence[Dict[str, object]]) -> None:
        """Replace the full endpoint set."""
        with self._lock:
            self._cache = {str(e["id"]): dict(e) for e in entries}
            self._commit()

    def upsert(self, entry: Dict[str, object]) -> None:
        with self._lock:
            self._load_locked()
            self._cache[str(entry["id"])] = dict(entry)
            self._commit()

    def remove(self, member_id: str) -> None:
        with self._lock:
            self._load_locked()
            self._cache.pop(member_id, None)
            self._commit()

    def set_draining(self, member_id: str,
                     draining: bool = True) -> None:
        with self._lock:
            self._load_locked()
            e = self._cache.get(member_id)
            if e is not None:
                e["draining"] = bool(draining)
                self._commit()

    def _commit(self) -> None:
        write_endpoint_file(
            self.path, {"v": 1, "endpoints": self._cache})
        try:
            self._mtime = os.stat(self.path).st_mtime
        except OSError:
            self._mtime = None

    def _load_locked(self) -> None:
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            self._cache = {}
            self._mtime = None
            return
        if mtime == self._mtime:
            return
        try:
            with open(self.path) as f:
                doc = json.load(f)
            self._cache = {str(k): dict(v) for k, v in
                           dict(doc.get("endpoints", {})).items()}
            self._mtime = mtime
        except (OSError, ValueError):
            pass  # cxxlint: disable=CXL006 -- torn concurrent replace or unreadable file: keeping the previous view and retrying at the next poll IS the recovery

    def changed(self) -> bool:
        """Cheap mtime probe — has the file moved since last read?"""
        try:
            return os.stat(self.path).st_mtime != self._mtime
        except OSError:
            return self._mtime is not None

    def read(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            self._load_locked()
            return {k: dict(v) for k, v in self._cache.items()}

    def endpoints(self, role: str = "") -> List[Dict[str, object]]:
        """Entries, optionally filtered by role, sorted by id."""
        table = self.read()
        rows = [e for e in table.values()
                if not role or e.get("role") == role]
        return sorted(rows, key=lambda e: str(e["id"]))


def sync_from_registry(balancer, registry: EndpointRegistry,
                       self_id: str) -> bool:
    """Apply the registry's current view to a live balancer: add new
    replicas, drop removed ones, propagate draining flags, and refresh
    the tier peer list (every balancer entry except ``self_id``).
    Returns True when anything changed. Shared by the
    ``task=fleet_balancer`` runtime and the in-process test fakes so
    both run the same reconciliation."""
    if not registry.changed():
        return False
    table = registry.read()
    changed = False
    seen = set()
    for e in table.values():
        if e.get("role") != "replica":
            continue
        rid = str(e["id"])
        seen.add(rid)
        if not balancer.has_replica(rid):
            balancer.add_replica(
                rid, str(e.get("host", "127.0.0.1")),
                int(e.get("http_port", 0)),
                int(e.get("binary_port", 0)),
                version=str(e.get("version", "")),
                kind=str(e.get("kind", "")) or "baseline")
            changed = True
        if balancer.set_replica_draining(
                rid, bool(e.get("draining", False))):
            changed = True
    for rid in balancer.replica_ids():
        if rid not in seen:
            balancer.remove_replica(rid)
            changed = True
    peers = [(str(e["id"]), str(e.get("host", "127.0.0.1")),
              int(e.get("http_port", 0)))
             for e in table.values()
             if e.get("role") == "balancer" and str(e["id"]) != self_id]
    if balancer.set_tier_peers(peers):
        changed = True
    return changed


# -- balancer process manager ---------------------------------------------


class BalancerProcess:
    """One spawned front-door process: handle + published ports."""

    def __init__(self, balancer_id: str, index: int,
                 proc: subprocess.Popen, host: str,
                 port_file: str, log_path: str):
        self.balancer_id = balancer_id
        self.index = index
        self.proc = proc
        self.host = host
        self.port_file = port_file
        self.log_path = log_path
        self.http_port = 0
        self.binary_port = 0
        self.stopped = False

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None


class BalancerManager:
    """Spawn/stop extra balancer processes (``task=fleet_balancer``)
    with the replica spawn discipline: CLI + overrides, port-file
    handshake, log capture, SpawnError with the log tail."""

    def __init__(self, conf_path: str, tier: FleetTierConfig,
                 extra_overrides: Sequence[str] = (),
                 launcher: Optional[Launcher] = None,
                 monitor_dir: str = ""):
        self.conf_path = conf_path
        self.tier = tier
        self.extra_overrides = list(extra_overrides)
        self.launcher = launcher or make_launcher(tier)
        self.monitor_dir = monitor_dir
        self._lock = threading.Lock()
        self._balancers: Dict[str, BalancerProcess] = {}
        self._closed = False
        os.makedirs(tier.fleet_dir, exist_ok=True)

    def _command(self, bid: str, index: int,
                 port_file: str) -> List[str]:
        overrides = [
            "task=fleet_balancer",
            "fleet_balancer_id=%s" % bid,
            "fleet_balancer_index=%d" % index,
            "fleet_balancers=%d" % self.tier.balancers,
            "fleet_http_port=0",
            "fleet_binary_port=0",
            "fleet_host=%s" % self.launcher.host(),
            "fleet_port_file=%s" % port_file,
            "fleet_registry=%s" % self.tier.registry_path,
            "fleet_duration_s=0",
            # the spawning conf may itself say task=fleet with replica
            # counts — the balancer task ignores those, but the canary
            # keys must not re-arm inside a door process
            "canary_source=",
        ]
        if self.monitor_dir:
            overrides += [
                "monitor=jsonl",
                "monitor_path=%s" % os.path.join(
                    self.monitor_dir, "%s.jsonl" % bid),
            ]
        else:
            overrides += ["monitor=none"]
        return ([sys.executable, "-m", "cxxnet_tpu_torch.main",
                 self.conf_path] + self.extra_overrides + overrides)

    def spawn(self, index: int) -> BalancerProcess:
        """Start door ``b<index>`` and block until it publishes its
        ports or dies; raises SpawnError with the log tail."""
        from .replica import SpawnError, _log_tail
        bid = "b%d" % index
        port_file = os.path.join(self.tier.fleet_dir,
                                 "%s.ports.json" % bid)
        log_path = os.path.join(self.tier.fleet_dir, "%s.log" % bid)
        if os.path.exists(port_file):
            os.remove(port_file)
        proc = self.launcher.launch(
            self._command(bid, index, port_file), log_path)
        bal = BalancerProcess(bid, index, proc, self.launcher.host(),
                              port_file, log_path)
        deadline = time.monotonic() + self.tier.spawn_timeout_s
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise SpawnError(
                    "balancer %s (pid %d) exited with code %s before "
                    "publishing ports; log tail:\n%s"
                    % (bid, proc.pid, proc.returncode,
                       _log_tail(log_path)))
            if os.path.exists(port_file):
                with open(port_file) as f:
                    ports = json.load(f)
                bal.http_port = int(ports["http_port"])
                bal.binary_port = int(ports["binary_port"])
                with self._lock:
                    if self._closed:
                        closed = True
                    else:
                        closed = False
                        self._balancers[bid] = bal
                if closed:
                    proc.terminate()
                    proc.wait()
                    raise SpawnError(
                        "balancer %s came up after the manager "
                        "closed; stopped" % bid)
                return bal
            time.sleep(0.05)
        proc.kill()
        proc.wait()
        raise SpawnError(
            "balancer %s (pid %d) timed out after %.0fs waiting for "
            "ports; log tail:\n%s"
            % (bid, proc.pid, self.tier.spawn_timeout_s,
               _log_tail(log_path)))

    def balancers(self) -> List[BalancerProcess]:
        with self._lock:
            return sorted(self._balancers.values(),
                          key=lambda b: b.index)

    def poll_dead(self) -> List[BalancerProcess]:
        """Doors that died without the manager stopping them — removed
        from the table so the controller can deregister and respawn."""
        dead = []
        with self._lock:
            for bid in list(self._balancers):
                bal = self._balancers[bid]
                if not bal.stopped and not bal.alive():
                    dead.append(bal)
                    del self._balancers[bid]
        return dead

    def stop(self, bal: BalancerProcess,
             timeout_s: float = 30.0) -> Optional[int]:
        with self._lock:
            bal.stopped = True
            self._balancers.pop(bal.balancer_id, None)
        if bal.alive():
            bal.proc.terminate()
            try:
                bal.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                bal.proc.kill()
                bal.proc.wait()
        return bal.proc.returncode

    def close(self) -> None:
        with self._lock:
            self._closed = True
        for bal in self.balancers():
            self.stop(bal)
