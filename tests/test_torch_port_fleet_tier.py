"""The port's fleet tier (``cxxnet_tpu_torch/fleet``: config, quota
shares, placement, canary, controller) against the reference's
(``cxxnet_tpu/fleet``), on the CPU.

The pure functions and the records are held EQUAL, not close: the same
``FleetTierConfig`` attributes and error messages, ``models_spec`` /
``version_of``, ``classify_load`` / ``aggregate_windows`` on the
reference tests' windows, ``canary_decision`` over the reference's
matrix, ``compute_shares``, ``QuotaShareManager`` admit and rebalance
sequences on an injected clock (token state bit for bit), the bytes
``EndpointRegistry`` writes (each package reading the other's file, torn
reads included) and ``sync_from_registry``. The controller's lifecycles
(scale-out, scale-in, self-heal, the wedged reap, the canary's promote
and rollbacks, the multi-door tier) run in both packages over the
reference tests' fake managers, whose in-process replicas are port
``FleetServer`` s of ``tests/test_fleet.py``'s MLP (``dev = cpu``), and
give the same ``fleet_scale`` and ``canary`` records, which each
package's schema validates. Three tests spawn real ``python -m
cxxnet_tpu_torch.main`` replica processes (``dev = cpu``); the
multi-process door soak is marked slow, as the reference marks its own.
"""

import http.client
import json
import os
import signal
import sys
import threading
import time
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cxxnet_tpu.fleet as rfleet
import cxxnet_tpu.fleet.quota_shares as rqs
import cxxnet_tpu.monitor as rmon
import cxxnet_tpu.monitor.schema as rschema
import cxxnet_tpu.serve as rserve
import cxxnet_tpu_torch.fleet as pfleet
import cxxnet_tpu_torch.fleet.quota_shares as pqs
import cxxnet_tpu_torch.monitor as pmon
import cxxnet_tpu_torch.monitor.schema as pschema
import cxxnet_tpu_torch.serve as pserve
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "ref": SimpleNamespace(fleet=rfleet, qs=rqs, mon=rmon, schema=rschema,
                           serve=rserve),
    "port": SimpleNamespace(fleet=pfleet, qs=pqs, mon=pmon, schema=pschema,
                            serve=pserve),
}

# tests/test_fleet.py's MLP
MLP_CONF = """
netconfig=start
layer[+1:h] = fullc:fc1
  nhidden = 16
  init_sigma = 0.05
layer[+1] = relu
layer[h->o] = fullc:fc2
  nhidden = 4
  init_sigma = 0.05
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 16
eta = 0.1
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _save_mlp(path, seed=0):
    t = NetTrainer(parse_config(MLP_CONF) + [("seed", str(seed))],
                   device="cpu")
    t.init_model()
    t.save_model(str(path))


def _outcome(fn, *a, **k):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*a, **k))
    except (ValueError, KeyError) as e:
        return ("raise", type(e).__name__, str(e))


# -- pure: config grammar --------------------------------------------------

ALL_KEYS = [
    ("model_in", "m.npz"), ("fleet_replicas", "3"),
    ("fleet_min_replicas", "2"), ("fleet_max_replicas", "5"),
    ("fleet_http_port", "8080"), ("fleet_binary_port", "-1"),
    ("fleet_host", "0.0.0.0"), ("fleet_dir", "/run/fleet"),
    ("fleet_source", "/b/0003.model.bundle"),
    ("fleet_health_poll_s", "0.25"), ("fleet_unhealthy_after", "3"),
    ("fleet_wedged_after_s", "12.5"), ("fleet_retries", "5"),
    ("fleet_channels_per_replica", "4"), ("fleet_coalesce_ms", "2.5"),
    ("fleet_coalesce_rows", "64"), ("fleet_spawn_timeout_s", "90"),
    ("fleet_scale_interval_s", "0.5"), ("fleet_scale_up_after_s", "1.5"),
    ("fleet_scale_down_after_s", "20"), ("fleet_queue_hi", "2"),
    ("fleet_queue_lo", "0.1"), ("fleet_shed_hi", "0.5"),
    ("fleet_slo_p99_ms", "80"), ("fleet_duration_s", "30"),
    ("canary_source", "/b/0004.model.bundle"), ("canary_model", "default"),
    ("canary_fraction", "0.3"), ("canary_window_s", "12"),
    ("canary_min_requests", "9"), ("canary_max_error_rate", "0.01"),
    ("canary_p99_ratio", "2.5"), ("canary_out", "/run/d.json"),
    ("fleet_gossip_s", "0.3"), ("fleet_quota_rebalance_s", "1.5"),
    ("fleet_registry", "/run/endpoints.json"),
    ("fleet_port_file", "/run/b0.ports.json")]

CONFIG_CASES = {
    "defaults": [("model_in", "snap.npz")],
    "bounds": [("model_in", "snap.npz"), ("fleet_replicas", "2"),
               ("fleet_max_replicas", "6"), ("fleet_slo_p99_ms", "100"),
               ("canary_fraction", "0.25")],
    "serve_models": [("serve_models", "main=./m1;alt=./m2|1,8"),
                     ("canary_source", "./m1b")],
    "model_dir": [("model_dir", "./models"), ("fleet_source", "")],
    "datapath": [("model_in", "x"), ("fleet_channels_per_replica", "0"),
                 ("fleet_coalesce_ms", "2.5"),
                 ("fleet_coalesce_rows", "64")],
    "front_tier": [("model_in", "x"), ("fleet_balancers", "3"),
                   ("fleet_balancer_index", "2"),
                   ("fleet_launcher", "ssh"),
                   ("fleet_hosts", "h1, h2,,h3")],
    "door_id": [("model_in", "x"), ("fleet_balancers", "2"),
                ("fleet_balancer_id", "door-east"),
                ("fleet_balancer_index", "1")],
    "all_keys": ALL_KEYS,
    # the errors of the reference's tests and every other check
    "no_source": [],
    "zero_replicas": [("model_in", "x"), ("fleet_replicas", "0")],
    "initial_over_max": [("model_in", "x"), ("fleet_replicas", "5"),
                         ("fleet_max_replicas", "2")],
    "min_over_initial": [("model_in", "x"), ("fleet_replicas", "2"),
                         ("fleet_min_replicas", "3")],
    "canary_fraction": [("model_in", "x"), ("canary_fraction", "1.5")],
    "canary_model": [("serve_models", "a=./x"), ("canary_source", "./y"),
                     ("canary_model", "ghost")],
    "no_listener": [("model_in", "x"), ("fleet_http_port", "-1"),
                    ("fleet_binary_port", "-1")],
    "channels": [("model_in", "x"), ("fleet_channels_per_replica", "-1")],
    "coalesce_ms": [("model_in", "x"), ("fleet_coalesce_ms", "-1")],
    "coalesce_rows": [("model_in", "x"), ("fleet_coalesce_rows", "0")],
    "balancers": [("model_in", "x"), ("fleet_balancers", "0")],
    "balancer_index": [("model_in", "x"), ("fleet_balancers", "2"),
                       ("fleet_balancer_index", "2")],
    "gossip": [("model_in", "x"), ("fleet_gossip_s", "0")],
    "rebalance": [("model_in", "x"), ("fleet_quota_rebalance_s", "-1")],
    "launcher": [("model_in", "x"), ("fleet_launcher", "k8s")],
    "ssh_hosts": [("model_in", "x"), ("fleet_launcher", "ssh")],
    "canary_doors": [("model_in", "x"), ("fleet_balancers", "2"),
                     ("canary_source", "./y")],
    "bad_int": [("model_in", "x"), ("fleet_replicas", "two")],
}


def _config_view(fleet, pairs):
    c = fleet.FleetTierConfig(pairs)
    return (vars(c), c.registry_path, c.models_with_source("./new"),
            c.target_version(c.models_with_source("./new")),
            c.target_version(c.models))


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_tier_config_same(case):
    pairs = CONFIG_CASES[case]
    ref = _outcome(_config_view, rfleet, pairs)
    port = _outcome(_config_view, pfleet, pairs)
    assert port == ref
    if case in ("defaults", "bounds", "serve_models", "all_keys"):
        assert ref[0] == "ok"


@pytest.mark.parametrize("entries", [
    [("a", "./x", ""), ("b", "./y", "1,8")],
    [("a", "./x", ""), ("b", "./y", "")],
    [("main", "/m/0002.model.bundle", "")],
    [("a", "./x", "1,4,16"), ("b", "./y", "2")],
])
def test_models_spec_same(entries):
    spec = pfleet.models_spec(entries)
    assert spec == rfleet.models_spec(entries)
    assert pserve.FleetConfig._parse_models(spec) == entries
    assert rserve.FleetConfig._parse_models(spec) == entries


@pytest.mark.parametrize("source", [
    "/m/0002.model.bundle", "/m/dir/", "x", "", "/", "rel/0001.model.npz",
    "memory://ckpt/0003.model.npz"])
def test_version_of_same(source):
    assert pfleet.version_of(source) == rfleet.version_of(source)


# -- pure: autoscale classification and windows ----------------------------

BASE_W = {"requests": 100, "ok": 100, "shed": 0, "errors": 0,
          "p99_ms": 10.0, "queue_rows": 8, "max_batch": 16, "ready": 2}
LOW_W = {"requests": 50, "ok": 50, "shed": 0, "p99_ms": 20.0,
         "queue_rows": 0, "max_batch": 16, "ready": 2}
CLASSIFY_CASES = [
    (BASE_W, {"fleet_slo_p99_ms": 100}),
    (dict(BASE_W, queue_rows=40), {"fleet_slo_p99_ms": 100}),
    (dict(BASE_W, shed=10), {"fleet_slo_p99_ms": 100}),
    (dict(BASE_W, p99_ms=150.0), {"fleet_slo_p99_ms": 100}),
    (dict(BASE_W, p99_ms=150.0), {}),
    ({"requests": 0, "queue_rows": 0, "ready": 1, "max_batch": 16},
     {"fleet_slo_p99_ms": 100}),
    (LOW_W, {"fleet_slo_p99_ms": 100}),
    (dict(LOW_W, p99_ms=80.0), {"fleet_slo_p99_ms": 100}),
    (dict(LOW_W, queue_rows=8), {"fleet_slo_p99_ms": 100}),
    ({"requests": 200, "ok": 100, "shed": 50, "errors": 0, "p99_ms": 50.0,
      "queue_rows": 64, "max_batch": 16, "ready": 1}, {}),
    ({}, {"fleet_queue_hi": 0.5, "fleet_queue_lo": 0.2}),
    ({"requests": 3, "forwards": 3, "coalesce_fill": 1.0,
      "channel_depth": 0, "queue_rows": 0, "ready": 2, "max_batch": 16,
      "ok": 3, "p99_ms": 2.0}, {}),
]


def _tier(fleet, over):
    return fleet.FleetTierConfig(
        [("model_in", "x")] + [(k, str(v)) for k, v in over.items()])


@pytest.mark.parametrize("stats,over", CLASSIFY_CASES)
def test_classify_load_same(stats, over):
    ref = rfleet.classify_load(stats, _tier(rfleet, over))
    assert pfleet.classify_load(stats, _tier(pfleet, over)) == ref


W0 = {"requests": 10, "ok": 9, "shed": 1, "errors": 0, "forwards": 9,
      "channel_depth": 2, "queue_rows": 8, "max_batch": 16, "ready": 2,
      "replicas": 2, "p99_ms": 12.0, "window_s": 1.0, "coalesce_fill": 0.5}
W1 = {"requests": 30, "ok": 30, "shed": 0, "errors": 0, "forwards": 27,
      "channel_depth": 1, "queue_rows": 4, "max_batch": 16, "ready": 2,
      "replicas": 2, "p99_ms": 30.0, "window_s": 1.2, "coalesce_fill": 1.0}


@pytest.mark.parametrize("windows", [[W0, W1], [W0], [], [W1, W0, W1],
                                     [{"requests": 5}, {}]])
def test_aggregate_windows_same(windows):
    assert pfleet.aggregate_windows(windows) == \
        rfleet.aggregate_windows(windows)


# -- pure: the canary's decision -------------------------------------------

C_BASE = {"ok": 500, "errors": 0, "requests": 500, "p99_ms": 10.0}
CANARY_CASES = [
    (C_BASE, {"ok": 100, "errors": 0, "requests": 100, "p99_ms": 12.0}),
    (C_BASE, {"ok": 5, "errors": 0, "requests": 5, "p99_ms": 1.0}),
    (C_BASE, {"ok": 80, "errors": 20, "requests": 100, "p99_ms": 10.0}),
    (C_BASE, {"ok": 100, "errors": 0, "requests": 100, "p99_ms": 25.0}),
    ({"ok": 90, "errors": 10, "requests": 100, "p99_ms": 10.0},
     {"ok": 93, "errors": 7, "requests": 100, "p99_ms": 11.0}),
    ({}, {"ok": 30, "errors": 0, "requests": 30, "p99_ms": 3.0}),
    ({"ok": 50, "errors": 0, "requests": 50, "p99_ms": 0.0},
     {"ok": 0, "errors": 20, "requests": 20, "p99_ms": 0.0}),
]


@pytest.mark.parametrize("base,cane", CANARY_CASES)
def test_canary_decision_same(base, cane):
    over = {"canary_min_requests": 20, "canary_max_error_rate": 0.05,
            "canary_p99_ratio": 2.0}
    ref = rfleet.canary_decision(base, cane, _tier(rfleet, over))
    assert pfleet.canary_decision(base, cane, _tier(pfleet, over)) == ref


# -- pure: quota shares ------------------------------------------------------

@pytest.mark.parametrize("demand,n", [
    ({"b0": 80.0, "b1": 10.0, "b2": 10.0}, 3),
    ({"b0": 100.0, "b1": 0.0}, 2),
    ({"b0": 123.0}, 1), ({"b0": 0.0}, 1),
    ({"b0": 0.0, "b1": 0.0, "b2": 0.0}, 3),
    ({"b0": 50.0, "b1": 50.0}, 4), ({}, 3),
    ({"b2": 1e-9, "b0": 7.5, "b1": 3.25}, 3),
])
def test_compute_shares_same(demand, n):
    ref = rfleet.compute_shares(demand, n)
    assert pfleet.compute_shares(demand, n) == ref
    assert pfleet.compute_shares(dict(reversed(list(demand.items()))),
                                 n) == ref


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _admit(mgr, tenant, rows, err):
    try:
        mgr.admit(tenant, rows)
        return ("ok", 0.0)
    except err as e:
        return ("shed", e.retry_after_s)


def _buckets(mgr):
    return {t: (b.rate, b.burst, b._tokens)
            for t, b in sorted(mgr._buckets.items())}


def _single_door(pkg, clock):
    """The reference's single-door steps, a rebalance between each: the
    trace of outcomes and token state."""
    p = PKG[pkg]
    cfg = [("serve_quota", "t:5:2,u:3"), ("serve_quota_default", "100")]
    sm = p.qs.QuotaShareManager(cfg, balancer_id="b0", balancers=1)
    err = p.serve.TenantQuotaError
    trace = []
    for tenant, rows, dt in [("t", 1, 0.0), ("t", 1, 0.05), ("t", 2, 0.0),
                             ("t", 1, 0.3), ("u", 3, 0.0), ("u", 1, 0.1),
                             ("anon", 50, 0.0), ("t", 1, 1.7),
                             ("t", 2, 0.01)]:
        clock.advance(dt)
        trace.append(_admit(sm, tenant, rows, err))
        sm.rebalance({"b0": sm.sample_demand()})
        trace.append(_buckets(sm))
    trace.append((dict(sm.counters), dict(sm.shed_by_tenant)))
    return trace


def _rate_bound(pkg, clock):
    """The reference's three-door simulation: skewed demand that shifts
    mid-run, views one gossip round stale; the admitted rows and every
    door's fractions each round."""
    p = PKG[pkg]
    rate, burst, n = 100.0, 10.0, 3
    cfg = [("serve_quota", "hog:%g:%g" % (rate, burst))]
    doors = {bid: p.qs.QuotaShareManager(cfg, balancer_id=bid, balancers=n)
             for bid in ("b0", "b1", "b2")}
    err = p.serve.TenantQuotaError
    last, admitted, trace = {}, 0, []
    for rnd in range(20):
        hot = "b0" if rnd < 10 else "b2"
        for bid, mgr in doors.items():
            for _ in range(60 if bid == hot else 5):
                admitted += _admit(mgr, "hog", 1, err)[0] == "ok"
        clock.advance(0.25)
        if rnd % 2 == 1:
            prev = dict(last)
            fresh = {bid: mgr.sample_demand() for bid, mgr in doors.items()}
            for bid, mgr in doors.items():
                views = {q: prev.get(q, {}) for q in doors if q != bid}
                views[bid] = fresh[bid]
                mgr.rebalance(views)
            last = fresh
        trace.append((admitted, {bid: (dict(m._fracs), _buckets(m))
                                 for bid, m in doors.items()}))
        assert admitted <= rate * (0.25 * (rnd + 1) + 0.5) + burst + n
    return trace


def _raise_deferred(pkg, clock):
    """The reference's fleet-wide demand ramp: a raise waits a round."""
    p = PKG[pkg]
    cfg = [("serve_quota", "hog:100:10")]
    doors = {bid: p.qs.QuotaShareManager(cfg, balancer_id=bid, balancers=2)
             for bid in ("b0", "b1")}
    err = p.serve.TenantQuotaError
    clock.advance(0.5)
    for mgr in doors.values():
        for _ in range(40):
            _admit(mgr, "hog", 1, err)
    clock.advance(0.5)
    samples = {bid: m.sample_demand() for bid, m in doors.items()}
    trace = [samples]
    for bid, mgr in doors.items():
        mgr.rebalance({bid: samples[bid],
                       ("b1" if bid == "b0" else "b0"): {}})
    trace.append({bid: dict(m._fracs) for bid, m in doors.items()})
    assert all(m._fracs["hog"] <= 0.5 + 1e-9 for m in doors.values())
    for mgr in doors.values():
        mgr.rebalance({"b0": samples["b0"], "b1": samples["b1"]})
    trace.append({bid: (dict(m._fracs), m.share_snapshot())
                  for bid, m in doors.items()})
    return trace


@pytest.mark.parametrize("scenario", [_single_door, _rate_bound,
                                      _raise_deferred],
                         ids=lambda f: f.__name__.strip("_"))
def test_quota_share_sequences_same(scenario, monkeypatch):
    traces = {}
    for pkg in ("ref", "port"):
        clock = _FakeClock()
        monkeypatch.setattr(time, "monotonic", clock)
        traces[pkg] = scenario(pkg, clock)
    assert traces["port"] == traces["ref"]


def test_single_door_bit_identical_to_quota_manager(monkeypatch):
    """One door's share manager is the plain QuotaManager: the same
    decisions, retry_after and token floats, across rebalances."""
    clock = _FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    cfg = [("serve_quota", "t:5:2,u:3"), ("serve_quota_default", "100")]
    qm = pserve.QuotaManager(cfg)
    sm = pqs.QuotaShareManager(cfg, balancer_id="b0", balancers=1)
    for tenant, rows, dt in [("t", 1, 0.0), ("t", 1, 0.05), ("t", 2, 0.0),
                             ("t", 1, 0.3), ("u", 3, 0.0), ("anon", 50, 0.0),
                             ("t", 1, 1.7), ("t", 2, 0.01)]:
        clock.advance(dt)
        assert _admit(qm, tenant, rows, pserve.TenantQuotaError) == \
            _admit(sm, tenant, rows, pserve.TenantQuotaError)
        sm.rebalance({"b0": sm.sample_demand()})
        assert _buckets(qm) == _buckets(sm)
    assert qm.counters == sm.counters


# -- placement: the registry, launchers, reconciliation --------------------

def _entries(fleet):
    e = fleet.endpoint_entry
    return [e("r001", "replica", "127.0.0.1", 80, 81, version="v1", pid=42),
            e("b0", "balancer", "127.0.0.1", 90, 91),
            e("b1", "balancer", "10.0.0.2", 92, 93, draining=True),
            e("r002", "replica", "127.0.0.1", 82, 0, kind="canary")]


def _registry_steps(fleet, path):
    """Write, upsert, drain, remove: the file's bytes after each step."""
    reg = fleet.EndpointRegistry(path)
    out = []
    for step in (lambda: reg.write(_entries(fleet)),
                 lambda: reg.upsert(fleet.endpoint_entry(
                     "r003", "replica", "127.0.0.1", 84, 85, "v2")),
                 lambda: reg.set_draining("r001"),
                 lambda: reg.remove("r002"),
                 lambda: reg.set_draining("ghost")):
        step()
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def test_registry_bytes_same(tmp_path):
    ref = _registry_steps(rfleet, str(tmp_path / "ref" / "endpoints.json"))
    port = _registry_steps(pfleet, str(tmp_path / "port" / "endpoints.json"))
    assert port == ref
    assert pfleet.endpoint_entry("x", "replica", "h", "1", 2.0) == \
        rfleet.endpoint_entry("x", "replica", "h", "1", 2.0)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")])
def test_registry_read_across_and_torn(tmp_path, writer, reader):
    """Each package reads the other's file; a torn or garbage overwrite
    keeps the reader's previous view until a good write lands."""
    path = str(tmp_path / "endpoints.json")
    w = PKG[writer].fleet.EndpointRegistry(path)
    r = PKG[reader].fleet.EndpointRegistry(path)
    w.write(_entries(PKG[writer].fleet))
    assert r.endpoints() == w.endpoints()
    assert [e["id"] for e in r.endpoints("balancer")] == ["b0", "b1"]
    assert PKG[reader].serve.registry_endpoints(path) == [("127.0.0.1", 91)]
    assert pserve.registry_endpoints(path, role="replica", proto="http") \
        == rserve.registry_endpoints(path, role="replica", proto="http")
    before = r.endpoints()
    with open(path, "w") as f:
        f.write('{"v": 1, "endpoints": {"r0')
    assert r.changed()
    assert r.endpoints() == before
    w._mtime = None
    w.write(_entries(PKG[writer].fleet)[:1])
    assert [e["id"] for e in r.endpoints()] == ["r001"]
    assert not r.changed()


class _SyncTarget:
    """The balancer surface ``sync_from_registry`` drives, recorded."""

    def __init__(self):
        self.reps, self.peers, self.log = {}, [], []

    def has_replica(self, rid):
        return rid in self.reps

    def add_replica(self, rid, host, http_port, binary_port, version="",
                    kind="baseline"):
        self.reps[rid] = [host, http_port, binary_port, version, kind,
                          False]
        self.log.append(("add", rid, host, http_port, binary_port, version,
                         kind))

    def set_replica_draining(self, rid, draining):
        changed = self.reps[rid][5] != draining
        self.reps[rid][5] = draining
        if changed:
            self.log.append(("drain", rid, draining))
        return changed

    def replica_ids(self):
        return sorted(self.reps)

    def remove_replica(self, rid):
        del self.reps[rid]
        self.log.append(("remove", rid))

    def set_tier_peers(self, peers):
        changed = sorted(peers) != self.peers
        self.peers = sorted(peers)
        return changed


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sync_from_registry_same(tmp_path, writer):
    """Both packages reconcile a balancer from the same registry file the
    same way (adds, drains, removals, peers), and a live port balancer
    ends where the reference's does."""
    fleet = PKG[writer].fleet
    path = str(tmp_path / "endpoints.json")
    reg = fleet.EndpointRegistry(path)
    targets = {pkg: _SyncTarget() for pkg in PKG}
    readers = {pkg: PKG[pkg].fleet.EndpointRegistry(path) for pkg in PKG}
    tier = [("model_in", "x"), ("fleet_http_port", "0"),
            ("fleet_binary_port", "-1")]
    live = {pkg: PKG[pkg].fleet.FleetBalancer(
        PKG[pkg].fleet.FleetTierConfig(tier), tier) for pkg in PKG}
    lreaders = {pkg: PKG[pkg].fleet.EndpointRegistry(path) for pkg in PKG}
    e = fleet.endpoint_entry
    steps = [
        lambda: reg.write([e("r001", "replica", "127.0.0.1", 1, 2, "v1"),
                           e("r002", "replica", "127.0.0.1", 3, 4, "v1",
                             kind="canary"),
                           e("b0", "balancer", "127.0.0.1", 5, 6),
                           e("b1", "balancer", "127.0.0.1", 7, 8)]),
        lambda: None,
        lambda: (reg.set_draining("r001"), reg.remove("r002"),
                 reg.remove("b1")),
        lambda: reg.upsert(e("r003", "replica", "10.0.0.9", 9, 10, "v2")),
    ]
    try:
        for i, step in enumerate(steps):
            time.sleep(0.01)         # a distinct mtime for each write
            step()
            got = {pkg: PKG[pkg].fleet.sync_from_registry(
                targets[pkg], readers[pkg], "b0") for pkg in PKG}
            assert got["port"] == got["ref"] == (i != 1)
            assert targets["port"].log == targets["ref"].log
            assert targets["port"].peers == targets["ref"].peers
            for pkg in PKG:
                PKG[pkg].fleet.sync_from_registry(live[pkg], lreaders[pkg],
                                                  "b0")
            assert live["port"].replica_ids() == live["ref"].replica_ids()
            assert live["port"].tier_peers() == live["ref"].tier_peers()
        for pkg in PKG:
            with live[pkg]._lock:
                assert live[pkg]._reps["r001"].draining
    finally:
        for bal in live.values():
            bal.close()
    assert targets["port"].reps == targets["ref"].reps


def test_launchers_same(tmp_path):
    """The ssh stub's command contract and ``make_launcher`` match the
    reference's; the local launcher runs and logs with PYTHONPATH pinned
    to the checkout that holds ``cxxnet_tpu_torch``."""
    argv = ["python", "-m", "cxxnet_tpu_torch.main", "f.conf",
            "task=fleet_balancer", "a b"]
    for hosts in (["hostA", "hostB"], ["solo"]):
        assert pfleet.SshLauncher(hosts).command(argv) == \
            rfleet.SshLauncher(hosts).command(argv)
    assert _outcome(pfleet.SshLauncher, []) == \
        _outcome(rfleet.SshLauncher, [])
    with pytest.raises(pfleet.PlacementError):
        pfleet.SshLauncher(["h"]).launch(["python"], "/dev/null")
    for pairs, cls in (([("fleet_launcher", "ssh"), ("fleet_hosts", "h1")],
                        "SshLauncher"), ([], "LocalLauncher")):
        t = [("model_in", "x")] + pairs
        assert type(pfleet.make_launcher(
            pfleet.FleetTierConfig(t))).__name__ == cls
    ln = pfleet.LocalLauncher()
    assert ln.host() == "127.0.0.1" and ln.kind == "local"
    log = str(tmp_path / "x.log")
    proc = ln.launch([sys.executable, "-c",
                      "import cxxnet_tpu_torch, os; print('door says hi', "
                      "os.path.dirname(os.path.dirname("
                      "os.path.abspath(cxxnet_tpu_torch.__file__))))"], log)
    assert proc.wait(timeout=60) == 0
    with open(log) as f:
        said = f.read().split()
    assert said[:2] == ["door", "hi"] or said[:3] == ["door", "says", "hi"]
    assert os.path.realpath(said[-1]) == os.path.realpath(REPO)


def test_balancer_manager_spawn_failure_reports_log(tmp_path):
    """A door that dies before publishing its ports is a SpawnError with
    the log tail; the door command is the port's CLI."""

    class _CrashLauncher(pfleet.LocalLauncher):
        def launch(self, argv, log_path):
            self.argv = list(argv)
            return super().launch(
                [sys.executable, "-c", "import sys; print('door boot "
                 "exploded'); sys.exit(3)"], log_path)

    tier = pfleet.FleetTierConfig([("model_in", str(tmp_path / "x.npz")),
                                   ("fleet_balancers", "2"),
                                   ("fleet_dir", str(tmp_path / "run"))])
    ln = _CrashLauncher()
    mgr = pfleet.BalancerManager(str(tmp_path / "f.conf"), tier,
                                 extra_overrides=["dev=cpu"], launcher=ln)
    try:
        with pytest.raises(pfleet.SpawnError, match="door boot exploded"):
            mgr.spawn(1)
    finally:
        mgr.close()
    assert ln.argv[1:4] == ["-m", "cxxnet_tpu_torch.main",
                            str(tmp_path / "f.conf")]
    assert "dev=cpu" in ln.argv and "task=fleet_balancer" in ln.argv


def test_replica_command_and_post_close_registration(tmp_path,
                                                     monkeypatch):
    """The replica command is the port's CLI with the reference's pinned
    overrides; a spawn that completes after close() stops the fresh
    process instead of leaking it."""
    tier = pfleet.FleetTierConfig([("model_in", str(tmp_path / "x.npz")),
                                   ("fleet_dir", str(tmp_path / "run"))])
    rtier = rfleet.FleetTierConfig([("model_in", str(tmp_path / "x.npz")),
                                    ("fleet_dir", str(tmp_path / "run"))])
    mgr = pfleet.ReplicaManager(str(tmp_path / "f.conf"), tier,
                                extra_overrides=["dev=cpu"])
    rmgr = rfleet.ReplicaManager(str(tmp_path / "f.conf"), rtier,
                                 extra_overrides=["dev=cpu"])
    pf = str(tmp_path / "run" / "r001.ports.json")
    cmd = mgr._command("r001", tier.models, pf)
    assert cmd[1:3] == ["-m", "cxxnet_tpu_torch.main"]
    assert cmd[3:] == rmgr._command("r001", rtier.models, pf)[3:]
    for pinned in ("serve_swap_poll_s=0", "serve_quota=",
                   "serve_quota_default=", "monitor=none",
                   "serve_port_file=" + pf, "task=serve_fleet"):
        assert pinned in cmd
    mgr.close()

    class _Proc:
        pid = 4242
        returncode = None
        terminated = False

        def poll(self):
            return None

        def terminate(self):
            self.terminated = True

        def wait(self, timeout=None):
            return 0

        def kill(self):
            self.terminated = True

    proc = _Proc()

    def fake_popen(*a, **k):
        with open(pf, "w") as f:
            json.dump({"pid": 4242, "http_port": 1, "binary_port": 2}, f)
        return proc

    monkeypatch.setattr("cxxnet_tpu_torch.fleet.placement.subprocess.Popen",
                        fake_popen)
    with pytest.raises(pfleet.SpawnError, match="after the manager closed"):
        mgr.spawn(tier.models, "v1")
    assert proc.terminated and mgr.replicas() == []


# -- the controller over fake managers, in both packages --------------------

def _mk_replica(snap):
    """A port replica of the MLP: any package's balancer speaks to it."""
    cfg = parse_config(MLP_CONF) + [
        ("serve_models", "default=%s" % snap), ("dev", "cpu"),
        ("serve_http_port", "0"), ("serve_binary_port", "0"),
        ("serve_swap_poll_s", "0"), ("serve_max_delay_ms", "1"),
        ("serve_queue_rows", "4096")]
    server = pserve.FleetServer(cfg)
    server.start()
    return server


class _FakeReplica:
    def __init__(self, rid, server, models, version, kind):
        self.replica_id = rid
        self.server = server
        self.models = list(models)
        self.version = version
        self.kind = kind
        self.http_port = server.http_port
        self.binary_port = server.binary_port
        self.stopped = False
        self.dead = False
        self.proc = types.SimpleNamespace(returncode=None)

    @property
    def pid(self):
        return 0

    def alive(self):
        return not self.dead


class _FakeManager:
    """The reference tests' ReplicaManager surface over in-process
    servers; ``spawn_error`` is the package's SpawnError."""

    def __init__(self, spawn_error, fail_sources=()):
        self.spawn_error = spawn_error
        self.fail_sources = set(fail_sources)
        self._seq = 0
        self._reps = {}
        self.spawn_log = []

    def spawn(self, models, version, kind="baseline"):
        for _, src, _ in models:
            if src in self.fail_sources:
                raise self.spawn_error("injected bad bundle: %s" % src)
        self._seq += 1
        rid = "f%03d" % self._seq
        rep = _FakeReplica(rid, _mk_replica(models[0][1]), models, version,
                           kind)
        self._reps[rid] = rep
        self.spawn_log.append((rid, version, kind))
        return rep

    def stop(self, rep, timeout_s=30.0):
        rep.stopped = True
        self._reps.pop(rep.replica_id, None)
        rep.server.close()
        return 0

    def poll_dead(self):
        dead = [r for r in self._reps.values() if r.dead and not r.stopped]
        for r in dead:
            del self._reps[r.replica_id]
        return dead

    def replicas(self):
        return list(self._reps.values())

    def close(self):
        for rep in list(self._reps.values()):
            self.stop(rep)


class _FakeDoor:
    def __init__(self, bid, index, bal):
        self.balancer_id = bid
        self.index = index
        self.bal = bal
        self.host = "127.0.0.1"
        self.http_port = bal.http_port
        self.binary_port = bal.binary_port
        self.stopped = False
        self.dead = False
        self.proc = types.SimpleNamespace(returncode=None)

    @property
    def pid(self):
        return 0

    def alive(self):
        return not self.dead


class _FakeDoorManager:
    """The reference tests' BalancerManager surface over in-process doors
    of the package ``fleet``."""

    def __init__(self, fleet, pairs):
        self.fleet = fleet
        self.pairs = list(pairs)
        self._doors = {}
        self.spawn_log = []

    def spawn(self, index):
        bid = "b%d" % index
        pairs = [(k, v) for k, v in self.pairs
                 if k not in ("fleet_balancer_id", "fleet_balancer_index")]
        pairs += [("fleet_balancer_id", bid),
                  ("fleet_balancer_index", str(index)),
                  ("fleet_http_port", "0"), ("fleet_binary_port", "0")]
        bal = self.fleet.FleetBalancer(self.fleet.FleetTierConfig(pairs),
                                       pairs)
        bal.start()
        door = _FakeDoor(bid, index, bal)
        self._doors[bid] = door
        self.spawn_log.append(bid)
        return door

    def balancers(self):
        return sorted(self._doors.values(), key=lambda d: d.index)

    def poll_dead(self):
        dead = [d for d in self._doors.values() if d.dead and not d.stopped]
        for d in dead:
            del self._doors[d.balancer_id]
        return dead

    def stop(self, door, timeout_s=30.0):
        door.stopped = True
        self._doors.pop(door.balancer_id, None)
        door.bal.close()
        return 0

    def close(self):
        for d in list(self._doors.values()):
            self.stop(d)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    d = tmp_path_factory.mktemp("tier_snaps")
    s1, s2 = d / "0001.model.npz", d / "0002.model.npz"
    _save_mlp(s1, seed=0)
    _save_mlp(s2, seed=7)
    return SimpleNamespace(s1=str(s1), s2=str(s2), dir=d)


def _http_predict(port, tenant, rows, model=""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/predict",
                     json.dumps({"model": model, "tenant": tenant,
                                 "rows": rows.tolist()}))
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _stats(over, **kw):
    base = {"overload": {"requests": 200, "ok": 100, "shed": 50,
                         "errors": 0, "p99_ms": 50.0, "queue_rows": 64,
                         "max_batch": 16, "ready": 1, "replicas": 1,
                         "window_s": 1.0},
            "idle": {"requests": 0, "ok": 0, "shed": 0, "errors": 0,
                     "p99_ms": 0.0, "queue_rows": 0, "max_batch": 16,
                     "ready": 2, "replicas": 2, "window_s": 1.0}}[over]
    return dict(base, **kw)


def _scale_in_out_heal(pkg, fleet, mgr, ctl, snaps, tmp):
    ctl.spawn_replica()
    ctl._tick(stats=_stats("overload"))
    ctl._tick(stats=_stats("overload", ready=2))
    assert ctl.ready_count() == 2
    ctl._tick(stats=_stats("overload", ready=2))
    assert ctl.ready_count() == 2
    ctl._tick(stats=_stats("idle"))
    ctl._tick(stats=_stats("idle", ready=1))
    assert ctl.ready_count() == 1
    ctl._tick(stats=_stats("idle", ready=1))
    victim = mgr.replicas()[0]
    victim.dead = True
    victim.server.close()
    ctl._tick(stats=_stats("idle", ready=0))
    assert ctl.ready_count() == 1
    assert mgr.replicas()[0].replica_id != victim.replica_id


def _canary_promote(pkg, fleet, mgr, ctl, snaps, tmp):
    assert ctl.canary.state == "armed"
    ctl.spawn_replica()
    ctl.canary.arm()
    assert ctl.canary.state == "observing"
    rows = np.zeros((1, 64), np.float32)
    for _ in range(30):
        code, _ = _http_predict(ctl.balancer.http_port, "t", rows)
        assert code == 200
    assert ctl.balancer.version_stats()["0002.model.npz"]["ok"] == 15
    time.sleep(0.25)
    ctl.canary.step()
    assert ctl.canary.state == "promoted"
    assert ctl.current_version() == "0002.model.npz"
    assert all(r.version == "0002.model.npz" for r in mgr.replicas())
    assert ctl.balancer._pin_version is None
    code, _ = _http_predict(ctl.balancer.http_port, "t", rows)
    assert code == 200


def _canary_bad_bundle(pkg, fleet, mgr, ctl, snaps, tmp):
    ctl.spawn_replica()
    ctl.canary.arm()
    assert ctl.canary.state == "rolled_back"
    assert ctl.balancer._pin_version is None and ctl.ready_count() == 1
    code, _ = _http_predict(ctl.balancer.http_port, "t",
                            np.zeros((1, 64), np.float32))
    assert code == 200


def _canary_no_traffic(pkg, fleet, mgr, ctl, snaps, tmp):
    ctl.spawn_replica()
    ctl.canary.arm()
    time.sleep(0.55)
    ctl.canary.step()                  # one window: still waiting
    assert ctl.canary.state == "observing"
    time.sleep(1.0)                    # past three windows
    ctl.canary.step()
    assert ctl.canary.state == "rolled_back"


def _wedged_reap(pkg, fleet, mgr, ctl, snaps, tmp):
    ctl.spawn_replica()
    wedged = mgr.replicas()[0]
    wedged.server.close(drain=False)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        ctl._tick(stats=_stats("idle", ready=1))
        live = mgr.replicas()
        if live and live[0].replica_id != wedged.replica_id:
            break
        time.sleep(0.1)
    assert mgr.replicas()[0].replica_id != wedged.replica_id
    assert wedged.stopped


LIFECYCLES = {
    "scale_in_out_heal": (_scale_in_out_heal, [
        ("fleet_replicas", "1"), ("fleet_min_replicas", "1"),
        ("fleet_max_replicas", "2"), ("fleet_http_port", "0"),
        ("fleet_binary_port", "-1"), ("fleet_scale_up_after_s", "0"),
        ("fleet_scale_down_after_s", "0"),
        ("fleet_health_poll_s", "0.1")]),
    "canary_promote": (_canary_promote, [
        ("fleet_replicas", "1"), ("fleet_http_port", "0"),
        ("fleet_binary_port", "-1"), ("fleet_health_poll_s", "0.1"),
        ("canary_source", "{s2}"), ("canary_fraction", "0.5"),
        ("canary_window_s", "0.2"), ("canary_min_requests", "5"),
        # 15 requests a side: under load their p99s may lie 1.5x apart
        ("canary_p99_ratio", "1000"),
        ("canary_out", "{tmp}/decision.json")]),
    "canary_bad_bundle": (_canary_bad_bundle, [
        ("fleet_replicas", "1"), ("fleet_http_port", "0"),
        ("fleet_binary_port", "-1"), ("canary_source", "{bad}"),
        ("canary_out", "{tmp}/decision.json")]),
    "canary_no_traffic": (_canary_no_traffic, [
        ("fleet_replicas", "1"), ("fleet_http_port", "-1"),
        ("fleet_binary_port", "0"), ("canary_source", "{s2}"),
        ("canary_window_s", "0.5"), ("canary_out", "{tmp}/decision.json")]),
    "wedged_reap": (_wedged_reap, [
        ("fleet_replicas", "1"), ("fleet_http_port", "-1"),
        ("fleet_binary_port", "0"), ("fleet_health_poll_s", "0.1"),
        ("fleet_wedged_after_s", "0.2")]),
}


def _both(run):
    """``{pkg: run(pkg)}`` for both packages, run side by side (their
    waits overlap); an exception in either is raised here."""
    out, errs = {}, {}

    def call(pkg):
        try:
            out[pkg] = run(pkg)
        except BaseException as e:           # re-raised below
            errs[pkg] = e

    threads = [threading.Thread(target=call, args=(pkg,)) for pkg in PKG]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for e in errs.values():
        raise e
    return out


def _scale_view(records):
    """The records both packages must agree on: every ``fleet_scale``
    field, and each ``canary`` record but its measured times."""
    out = []
    for r in records:
        if r["event"] == "fleet_scale":
            out.append({k: v for k, v in r.items() if k != "t"})
        elif r["event"] == "canary":
            out.append({
                "event": "canary", "phase": r["phase"],
                "versions": (r["baseline_version"], r["canary_version"]),
                "fraction": r["fraction"], "window_s": r["window_s"],
                "reason": r["reason"] if "ms" not in r["reason"]
                else r["reason"].split(" ")[0],
                "keys": (sorted(r["baseline"]), sorted(r["canary"])),
                "counts": {side: {k: r[side].get(k) for k in
                                  ("ok", "errors", "requests")}
                           for side in ("baseline", "canary")}})
    return out


@pytest.mark.parametrize("name", sorted(LIFECYCLES))
def test_controller_lifecycle_same(snaps, tmp_path, name):
    """The reference tests' controller and canary lifecycles, run by
    each package's FleetController over fake managers of port replicas:
    the same actions, the same ``fleet_scale`` and ``canary`` records,
    valid under both schemas, the same decision files."""
    body, pairs = LIFECYCLES[name]

    def run(pkg):
        p = PKG[pkg]
        tmp = tmp_path / pkg
        tmp.mkdir()
        # a source never written: the same bad bundle in both runs
        bad = str(snaps.dir / "0009.bad")
        tier = [("model_in", snaps.s1)] + [
            (k, v.format(s2=snaps.s2, tmp=tmp, bad=bad)) for k, v in pairs]
        sink = p.mon.MemorySink()
        mgr = _FakeManager(p.fleet.SpawnError, fail_sources={bad})
        ctl = p.fleet.FleetController(tier, monitor=p.mon.Monitor(sink),
                                      manager=mgr)
        ctl.balancer.start()
        try:
            body(pkg, p.fleet, mgr, ctl, snaps, tmp)
        finally:
            ctl.close()
        decision = None
        if (tmp / "decision.json").exists():
            decision = json.loads((tmp / "decision.json").read_text())
        return sink.records, mgr.spawn_log, decision

    runs = _both(run)
    (rrec, rlog, rdec), (prec, plog, pdec) = runs["ref"], runs["port"]
    assert plog == rlog
    assert _scale_view(prec) == _scale_view(rrec)
    assert [r["event"] for r in prec] == [r["event"] for r in rrec]
    for recs in (rrec, prec):
        assert rschema.validate_records(recs, strict=False) == []
        assert pschema.validate_records(recs, strict=False) == []
    assert (pdec is None) == (rdec is None)
    if pdec is not None:
        assert sorted(pdec) == sorted(rdec)
        assert _scale_view([pdec]) == _scale_view([rdec])
        assert rschema.validate_record(pdec) == []
        assert pschema.validate_record(rdec) == []


def test_controller_multi_door_lifecycle_same(snaps, tmp_path):
    """fleet_balancers = 2 in both packages: door b0 in process, b1
    through a fake door manager; the registry names the whole fleet,
    windows aggregate across doors, a retire waits for the external
    door's drain, a dead door is reaped and respawned, close empties the
    registry. The port's registry file reads in the reference and the
    actions match."""
    def run(pkg):
        p = PKG[pkg]
        tmp = tmp_path / pkg
        pairs = [("model_in", snaps.s1), ("fleet_replicas", "2"),
                 ("fleet_min_replicas", "1"), ("fleet_balancers", "2"),
                 ("fleet_http_port", "0"), ("fleet_binary_port", "0"),
                 ("fleet_health_poll_s", "0.1"), ("fleet_gossip_s", "0.1"),
                 ("fleet_scale_interval_s", "60"),
                 ("fleet_dir", str(tmp / "run"))]
        sink = p.mon.MemorySink()
        mgr = _FakeManager(p.fleet.SpawnError)
        dmgr = _FakeDoorManager(p.fleet, pairs)
        ctl = p.fleet.FleetController(pairs, monitor=p.mon.Monitor(sink),
                                      manager=mgr, bal_manager=dmgr)
        stop = threading.Event()

        def door_sync(ctl=ctl, dmgr=dmgr, p=p, stop=stop):
            reader = p.fleet.EndpointRegistry(ctl.tier.registry_path)
            while not stop.wait(0.05):
                for d in dmgr.balancers():
                    p.fleet.sync_from_registry(d.bal, reader, d.balancer_id)

        syncer = threading.Thread(target=door_sync, daemon=True)
        try:
            ctl.start()
            syncer.start()
            doors = ctl.front_doors()
            assert [d["id"] for d in doors] == ["b0", "b1"]
            other = PKG["ref" if pkg == "port" else "port"].fleet
            table = other.EndpointRegistry(ctl.tier.registry_path).read()
            roles = sorted(e["role"] for e in table.values())
            assert roles == ["balancer"] * 2 + ["replica"] * 2
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and \
                    dmgr.balancers()[0].bal.health_snapshot()["ready"] < 2:
                time.sleep(0.05)
            rows = np.zeros((1, 64), np.float32)
            for d in doors:
                assert _http_predict(d["http_port"], "t", rows)[0] == 200
            w = ctl._take_fleet_window()
            assert w["balancers"] == 2 and w["requests"] >= 2
            victim = next(iter(ctl._reps.values()))
            ctl.retire_replica(victim, action="scale_in")
            assert victim.replica_id not in ctl.registry.read()
            dead = dmgr.balancers()[0]
            dead.dead = True
            dead.bal.close()
            ctl._tick(stats={"requests": 0, "queue_rows": 0, "ready": 1,
                             "max_batch": 16, "replicas": 1,
                             "window_s": 1.0})
            assert dmgr.spawn_log == ["b1", "b1"]
            assert "b1" in ctl.registry.read()
        finally:
            stop.set()
            syncer.join(timeout=10)
            ctl.close()
        assert ctl.registry.read() == {}
        return sink.records

    runs = _both(run)
    for recs in runs.values():
        assert rschema.validate_records(recs, strict=False) == []
        assert pschema.validate_records(recs, strict=False) == []
    assert _scale_view(runs["port"]) == _scale_view(runs["ref"])


def test_lost_replica_leaves_the_registry(snaps, tmp_path):
    """A difference kept on purpose: the port's controller removes a lost
    replica's registry entry, so external doors and failover clients stop
    naming it; the reference's leaves the entry behind. Both heal."""
    def run(pkg):
        p = PKG[pkg]
        pairs = [("model_in", snaps.s1), ("fleet_replicas", "2"),
                 ("fleet_http_port", "0"), ("fleet_binary_port", "-1"),
                 ("fleet_registry", str(tmp_path / pkg / "endpoints.json"))]
        mgr = _FakeManager(p.fleet.SpawnError)
        ctl = p.fleet.FleetController(pairs, manager=mgr)
        ctl.balancer.start()
        try:
            lost = ctl.spawn_replica()
            ctl.spawn_replica()
            lost.dead = True
            lost.server.close()
            ctl._tick(stats=_stats("idle", ready=1))
            return (lost.replica_id, sorted(ctl.registry.read()),
                    ctl.ready_count())
        finally:
            ctl.close()

    runs = _both(run)
    lost, port_ids, ready = runs["port"]
    assert ready == 2 and port_ids == ["f002", "f003"]
    assert runs["ref"] == (lost, ["f001", "f002", "f003"], 2)


# -- the real thing: replica processes of the port's CLI --------------------

def _conf(tmp, extra=""):
    conf = tmp / "fleet.conf"
    conf.write_text(MLP_CONF + "serve_max_delay_ms = 1\n"
                    "serve_queue_rows = 4096\n" + extra)
    return str(conf)


@pytest.fixture(scope="module")
def process_fleet(snaps, tmp_path_factory):
    """A port FleetController over two replica processes spawned through
    ``python -m cxxnet_tpu_torch.main`` (``dev = cpu`` in the config
    file)."""
    tmp = tmp_path_factory.mktemp("fleet_proc")
    conf = _conf(tmp, "dev = cpu\n")
    sink = pmon.MemorySink()
    pairs = parse_config(MLP_CONF) + [
        ("model_in", snaps.s1), ("fleet_replicas", "2"),
        ("fleet_min_replicas", "2"), ("fleet_max_replicas", "3"),
        ("fleet_http_port", "0"), ("fleet_binary_port", "0"),
        ("fleet_health_poll_s", "0.2"), ("fleet_scale_interval_s", "0.2"),
        ("fleet_dir", str(tmp / "run")), ("serve_quota", "free:5:2")]
    ctl = pfleet.FleetController(pairs, conf_path=conf,
                                 monitor=pmon.Monitor(sink))
    ctl.start()
    yield ctl, sink
    ctl.close()


def test_replica_processes_serve_both_protocols(process_fleet):
    """Two replica processes of the port's CLI behind the port's
    balancer answer HTTP, CXN1 (each package's client) and CXN2 with
    the same rows."""
    ctl, sink = process_fleet
    assert ctl.ready_count() == 2
    reps = ctl.manager.replicas()
    assert all(r.alive() and r.pid > 0 for r in reps)
    assert len({r.pid for r in reps}) == 2
    rows = np.random.RandomState(0).rand(2, 64).astype(np.float32)
    code, body = _http_predict(ctl.balancer.http_port, "gold", rows)
    assert code == 200 and body["rows"] == 2
    for client in (pserve.BinaryClient, rserve.BinaryClient):
        bc = client("127.0.0.1", ctl.balancer.binary_port)
        try:
            status, out = bc.predict(rows, tenant="gold")
        finally:
            bc.close()
        assert status == "ok"
        np.testing.assert_allclose(out, np.asarray(body["result"]),
                                   rtol=1e-5, atol=1e-6)
    import socket
    from cxxnet_tpu_torch.serve.frontend import (pack_request_v2,
                                                 read_reply_tagged)
    sock = socket.create_connection(("127.0.0.1",
                                     ctl.balancer.binary_port), timeout=30)
    try:
        sock.sendall(pack_request_v2(7, "", "gold", rows))
        corr, status, out = read_reply_tagged(sock.makefile("rb"))
    finally:
        sock.close()
    assert (corr, status) == (7, "ok")
    np.testing.assert_allclose(out, np.asarray(body["result"]), rtol=1e-5,
                               atol=1e-6)


def test_replica_process_kill_mid_traffic_zero_failures_and_heal(
        process_fleet):
    """SIGKILL a replica process under concurrent HTTP and binary load:
    no failed request, the loss derouted, the controller heals back to
    fleet_min_replicas with a new process, and no compile on any live
    replica."""
    ctl, sink = process_fleet
    rows = np.random.RandomState(1).rand(2, 64).astype(np.float32)
    stop = threading.Event()
    fails, oks = [], [0] * 4
    lock = threading.Lock()

    def bin_client(ci):
        bc = pserve.BinaryClient("127.0.0.1", ctl.balancer.binary_port)
        try:
            while not stop.is_set():
                status, _ = bc.predict(rows, tenant="gold")
                with lock:
                    if status == "ok":
                        oks[ci] += 1
                    else:
                        fails.append(status)
        finally:
            bc.close()

    def http_client(ci):
        while not stop.is_set():
            code, body = _http_predict(ctl.balancer.http_port, "gold", rows)
            with lock:
                if code == 200:
                    oks[ci] += 1
                else:
                    fails.append((code, body))

    threads = [threading.Thread(target=bin_client, args=(i,))
               for i in range(2)]
    threads += [threading.Thread(target=http_client, args=(i,))
                for i in range(2, 4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        victim = ctl.manager.replicas()[0]
        os.kill(victim.pid, signal.SIGKILL)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            live = [r for r in ctl.manager.replicas() if r.alive()]
            if len(live) >= 2 and victim.replica_id not in \
                    {r.replica_id for r in live}:
                break
            time.sleep(0.2)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert fails == [], fails[:5]
    assert sum(oks) > 20
    live = [r for r in ctl.manager.replicas() if r.alive()]
    assert len(live) == 2
    assert victim.replica_id not in {r.replica_id for r in live}
    actions = [r["action"] for r in sink.records
               if r["event"] == "fleet_scale"]
    assert "replica_lost" in actions
    assert all(r["status"] == "ok" for r in sink.records
               if r["event"] == "fleet_route" and r["tenant"] == "gold")
    for rep in live:
        conn = http.client.HTTPConnection("127.0.0.1", rep.http_port,
                                          timeout=30)
        try:
            conn.request("GET", "/healthz")
            h = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        assert all(m["compile_events"] == 0 for m in h["model_health"])
    assert pschema.validate_records(sink.records, strict=False) == []
    assert rschema.validate_records(sink.records, strict=False) == []


def test_main_task_fleet_no_device_spawn_error_then_runs_and_drains(
        snaps, tmp_path, monkeypatch, capsys):
    """``task = fleet`` through the port's CLI resolves no device. Without
    ``dev = cpu`` on a machine with no GPU its replica fails to boot, and
    the spawn fails with SpawnError and the replica's log tail (never a
    replica on the CPU in its place); with ``dev = cpu`` (a CLI override
    the replicas inherit) it boots its replica, serves for the duration,
    and drains, leaving a stream valid under both schemas."""
    from cxxnet_tpu_torch import main as pmain

    def no_device(*a, **k):
        raise AssertionError("task = fleet resolved a device")

    monkeypatch.setattr(pmain, "resolve_device", no_device)
    conf = _conf(tmp_path, """
task = fleet
model_in = %s
fleet_replicas = 1
fleet_http_port = 0
fleet_binary_port = -1
fleet_duration_s = 0.5
fleet_spawn_timeout_s = 120
monitor = jsonl
""" % snaps.s1)
    if not torch.cuda.is_available():
        with pytest.raises(pfleet.SpawnError, match="no CUDA device"):
            pmain.main([conf, "fleet_dir=%s" % (tmp_path / "gpu"),
                        "monitor_path=%s" % (tmp_path / "gpu.jsonl")])
    stream = tmp_path / "fleet.jsonl"
    rc = pmain.main([conf, "dev=cpu", "fleet_dir=%s" % (tmp_path / "run"),
                     "monitor_path=%s" % stream])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "fleet: balancer" in out and "1 replicas serving " \
        "0001.model.npz" in out
    records = pschema.read_jsonl(str(stream))
    assert pschema.validate_records(records, strict=False) == []
    assert rschema.validate_records(records, strict=False) == []
    events = [r["event"] for r in records]
    assert events[0] == "run_start" and events[-1] == "task_end"
    assert records[0]["platform"] == "cpu"
    actions = [r["action"] for r in records if r["event"] == "fleet_scale"]
    assert actions == ["replica_ready", "shutdown"]


@pytest.mark.slow
def test_door_processes_kill_soak(snaps, tmp_path):
    """Two ``task = fleet_balancer`` door processes of the port's CLI over
    in-process replicas, concurrent failover clients, one door SIGKILLed
    mid-soak: no failed request."""
    reps = [_mk_replica(snaps.s1) for _ in range(2)]
    conf = _conf(tmp_path, """
model_in = %s
fleet_balancers = 2
fleet_dir = %s
fleet_gossip_s = 0.2
fleet_health_poll_s = 0.2
dev = cpu
""" % (snaps.s1, tmp_path / "run"))
    tier = pfleet.FleetTierConfig(parse_config(open(conf).read()))
    reg = pfleet.EndpointRegistry(tier.registry_path)
    reg.write([pfleet.endpoint_entry("r%d" % i, "replica", "127.0.0.1",
                                     r.http_port, r.binary_port, "v1")
               for i, r in enumerate(reps)])
    mgr = pfleet.BalancerManager(conf, tier)
    fails, oks = [], [0] * 4
    lock = threading.Lock()
    stop = threading.Event()
    try:
        doors = []
        for i in range(2):
            door = mgr.spawn(i)
            reg.upsert(pfleet.endpoint_entry(
                door.balancer_id, "balancer", door.host, door.http_port,
                door.binary_port, pid=door.pid))
            doors.append(door)
        deadline = time.monotonic() + 60
        for door in doors:
            while True:
                try:
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", door.http_port, timeout=5)
                    conn.request("GET", "/healthz")
                    h = json.loads(conn.getresponse().read())
                    conn.close()
                    if h.get("ready") == 2 and h.get("balancers") == 2:
                        break
                except (OSError, ValueError):
                    pass             # the door is still booting
                assert time.monotonic() < deadline
                time.sleep(0.1)
        eps = [("127.0.0.1", d.binary_port) for d in doors]
        rows = np.random.RandomState(5).rand(2, 64).astype(np.float32)

        def client(ci):
            fc = pserve.FailoverBinaryClient(
                list(reversed(eps)) if ci % 2 else eps)
            try:
                while not stop.is_set():
                    status, _ = fc.predict(rows, tenant="gold")
                    with lock:
                        if status == "ok":
                            oks[ci] += 1
                        else:
                            fails.append(status)
            except IOError as e:
                with lock:
                    fails.append(repr(e))
            finally:
                fc.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.6)
            os.kill(doors[1].pid, signal.SIGKILL)
            time.sleep(1.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert fails == [], fails[:5]
        assert sum(oks) > 50
        assert mgr.poll_dead()[0].balancer_id == "b1"
    finally:
        stop.set()
        mgr.close()
        for r in reps:
            r.close()
