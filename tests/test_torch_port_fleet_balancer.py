"""The port's front-of-fleet balancer (``cxxnet_tpu_torch/fleet/
balancer.py``) against the reference's, on the CPU.

Two tiers over one reference snapshot of ``tests/test_fleet.py``'s MLP:
the reference's ``FleetBalancer`` in front of two reference
``FleetServer`` replicas, and the port's in front of two port replicas
(``dev = cpu``), with the same fleet-wide quota. The same requests go to
both over HTTP, CXN1 and CXN2, with each package's clients: the statuses,
HTTP codes, JSON keys, error kinds and ``Retry-After`` are the same, and
the ok rows agree within atol 1e-5 / rtol 1e-4, the tolerance of
``tests/test_torch_port_fleet.py``. On the port's tier: coalesced replies
are the bits of an uncoalesced forward at the same bucket, a replica's
loss mid-traffic fails no request, a drain stops routing and the canary
split is deterministic, as in the reference's. A mixed tier puts each
package's balancer in front of the other's replica and has a reference
door and a port door gossip ``/fleet/view``: the wire protocols are the
same.
"""

import http.client
import json
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cxxnet_tpu.fleet as rfleet
import cxxnet_tpu.serve.frontend as rf
import cxxnet_tpu_torch.fleet as pfleet
import cxxnet_tpu_torch.serve.frontend as pf
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.parallel import make_mesh
from cxxnet_tpu_torch.monitor import MemorySink, Monitor
from cxxnet_tpu_torch.monitor.schema import validate_records
from cxxnet_tpu_torch.serve import ServeSession
from cxxnet_tpu_torch.utils.config import parse_config

ATOL, RTOL = 1e-5, 1e-4

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
# the protocols and clients the reply tests run
PROTOS = [("http", "-"), ("cxn1", "ref"), ("cxn1", "port"), ("cxn2", "ref"),
          ("cxn2", "port")]
# a tenant of its own for each: a burst of 2 rows that does not refill
# within a test, so that the over-quota sequences are the same in both
# tiers
QUOTA = [("serve_quota", ",".join(["free:5:2"] + [
    "t-%s-%s:0.001:2" % pc for pc in PROTOS]))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _replica(pkg, snap):
    cfg = parse_config(MLP_CONF) + [
        ("serve_models", "default=%s" % snap),
        ("serve_http_port", "0"), ("serve_binary_port", "0"),
        ("serve_swap_poll_s", "0"), ("serve_max_delay_ms", "1"),
        ("serve_queue_rows", "4096")]
    if pkg == "port":
        server = pf.FleetServer(cfg + [("dev", "cpu")])
    else:
        server = rf.FleetServer(cfg)
    server.start()
    return server


def _balancer(fleet, snap, reps, extra=(), monitor=None, version="v1"):
    pairs = [("model_in", snap), ("fleet_http_port", "0"),
             ("fleet_binary_port", "0"), ("fleet_health_poll_s", "0.1")] \
        + QUOTA + list(extra)
    bal = fleet.FleetBalancer(fleet.FleetTierConfig(pairs), pairs,
                              monitor=monitor)
    bal.start()
    for i, r in enumerate(reps):
        bal.add_replica("r%d" % i, "127.0.0.1", r.http_port, r.binary_port,
                        version)
    return bal


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    """The reference's tier and the port's over one reference snapshot."""
    tmp = tmp_path_factory.mktemp("fleet_balancer")
    snap = str(tmp / "0001.model.npz")
    t = RefTrainer(parse_config(MLP_CONF) + [("seed", "0")],
                   mesh=make_mesh(1, 1))
    t.init_model()
    t.save_model(snap)
    made = []
    try:
        out = {}
        for pkg, fleet in (("ref", rfleet), ("port", pfleet)):
            reps = [_replica(pkg, snap) for _ in range(2)]
            made += reps
            sink = MemorySink() if pkg == "port" else None
            bal = _balancer(fleet, snap, reps,
                            monitor=Monitor(sink) if sink else None)
            made.append(bal)
            out[pkg] = SimpleNamespace(bal=bal, reps=reps, sink=sink)
        yield SimpleNamespace(snap=snap, **out)
    finally:
        for obj in reversed(made):
            obj.close()


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body)
        r = conn.getresponse()
        data = r.read()
        try:
            doc = json.loads(data)
        except ValueError:
            doc = data.decode(errors="replace")
        return r.status, doc, r.getheader("Retry-After")
    finally:
        conn.close()


def _predict(proto, client_pkg, port_http, port_bin, rows, model="",
             tenant="gold"):
    """One request: ``(status name, result rows or error, extra)``, where
    ``extra`` is the HTTP code, error JSON keys and Retry-After."""
    if proto == "http":
        code, doc, retry = _http(port_http, "POST", "/v1/predict",
                                 json.dumps({"model": model,
                                             "tenant": tenant,
                                             "rows": np.asarray(
                                                 rows).tolist()}))
        if code == 200:
            return ("ok", np.asarray(doc["result"], np.float32),
                    (code, sorted(doc), retry))
        return (doc.get("error"), None, (code, sorted(doc), retry,
                                         doc.get("error")))
    fr = rf if client_pkg == "ref" else pf
    if proto == "cxn1":
        bc = fr.BinaryClient("127.0.0.1", port_bin)
        try:
            status, res = bc.predict(rows, model=model, tenant=tenant)
        finally:
            bc.close()
    else:
        sock = socket.create_connection(("127.0.0.1", port_bin), timeout=30)
        rfile = sock.makefile("rb")
        try:
            sock.sendall(fr.pack_request_v2(5, model, tenant, rows))
            corr, status, res = fr.read_reply_tagged(rfile)
            assert corr == 5
        finally:
            rfile.close()
            sock.close()
    if status == "ok":
        return ("ok", np.asarray(res, np.float32), None)
    return (status, None, None)


REQUESTS = [
    ("ok3", dict(rows=3)),
    ("ok16", dict(rows=16)),
    ("unknown_model", dict(rows=2, model="ghost")),
    ("wrong_width", dict(rows=2, width=63)),
    ("too_many_rows", dict(rows=17)),
]


@pytest.mark.parametrize("proto,client_pkg", PROTOS)
def test_replies_same_as_reference_tier(tiers, proto, client_pkg):
    """Each request of ``REQUESTS`` and an over-quota sequence through
    both tiers: the same status (and HTTP code, JSON keys, error kind,
    Retry-After); ok rows within tolerance."""
    rng = np.random.RandomState(len(proto) * 10 + len(client_pkg))
    for name, spec in REQUESTS:
        rows = rng.rand(spec["rows"], spec.get("width", 64)).astype(
            np.float32)
        got = {pkg: _predict(proto, client_pkg, t.bal.http_port,
                             t.bal.binary_port, rows,
                             model=spec.get("model", ""))
               for pkg, t in (("ref", tiers.ref), ("port", tiers.port))}
        (rs, rrows, rx), (ps, prows, px) = got["ref"], got["port"]
        assert (ps, px) == (rs, rx), name
        if rs == "ok":
            assert prows.shape == rrows.shape == (spec["rows"], 4)
            np.testing.assert_allclose(prows, rrows, atol=ATOL, rtol=RTOL)
    # a fresh tenant: a burst of 2 rows, then typed over_quota replies
    tenant = "t-%s-%s" % (proto, client_pkg)
    seqs = {}
    for pkg, t in (("ref", tiers.ref), ("port", tiers.port)):
        seqs[pkg] = [_predict(proto, client_pkg, t.bal.http_port,
                              t.bal.binary_port,
                              np.zeros((1, 64), np.float32),
                              tenant=tenant)[::2] for _ in range(4)]
    assert seqs["port"] == seqs["ref"]
    assert [s[0] for s in seqs["port"]] == ["ok", "ok", "over_quota",
                                           "over_quota"]


def _keys(doc, depth=2):
    """The key structure of a JSON document, ``depth`` levels down."""
    if isinstance(doc, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in doc.items()}
    if isinstance(doc, list) and doc and depth:
        return [_keys(doc[0], depth - 1)]
    return type(doc).__name__


def test_introspection_same_as_reference_tier(tiers):
    """``/healthz``, ``/v1/models``, ``/fleet/view``, ``/fleet/window``
    and a missing path: the same codes and keys in both tiers, once a
    health poll has landed."""
    deadline = time.monotonic() + 20
    for t in (tiers.ref, tiers.port):
        while time.monotonic() < deadline:
            code, h, _ = _http(t.bal.http_port, "GET", "/healthz")
            if h["ready"] == 2 and all(r["p99_ms"] is not None
                                       for r in h["replicas"]):
                break
            time.sleep(0.05)
    for path, depth in (("/healthz", 2), ("/v1/models", 3),
                        ("/fleet/view", 1), ("/fleet/window", 1),
                        ("/nope", 1)):
        got = {pkg: _http(t.bal.http_port, "GET", path)
               for pkg, t in (("ref", tiers.ref), ("port", tiers.port))}
        (rc, rdoc, _), (pc, pdoc, _) = got["ref"], got["port"]
        assert pc == rc, path
        assert _keys(pdoc, depth) == _keys(rdoc, depth), path
    _, pm, _ = _http(tiers.port.bal.http_port, "GET", "/v1/models")
    _, rm, _ = _http(tiers.ref.bal.http_port, "GET", "/v1/models")
    assert pm["replica_versions"] == rm["replica_versions"] == {"v1": 2}


def test_drain_and_canary_pin_same_as_reference_tier(tiers):
    """A drained replica gets no request; a canary pinned at 0.25 takes
    exactly floor(40 * 0.25) of 40 requests; in both tiers."""
    rows = np.zeros((1, 64), np.float32)
    got = {}
    for pkg, t in (("ref", tiers.ref), ("port", tiers.port)):
        bal = t.bal
        assert bal.drain_replica("r1")
        before = t.reps[1].counters["requests"]
        for _ in range(8):
            assert _http(bal.http_port, "POST", "/v1/predict", json.dumps(
                {"tenant": "gold", "rows": rows.tolist()}))[0] == 200
        drained = t.reps[1].counters["requests"] - before
        with bal._lock:
            bal._reps["r1"].draining = False
            bal._reps["r1"].version = "v2"
        bal.pin_canary("v2", 0.25)
        try:
            for _ in range(40):
                assert _http(bal.http_port, "POST", "/v1/predict",
                             json.dumps({"tenant": "gold",
                                         "rows": rows.tolist()}))[0] == 200
            stats = bal.version_stats()
        finally:
            bal.unpin_canary()
            with bal._lock:
                bal._reps["r1"].version = "v1"
        got[pkg] = (drained, stats["v2"]["ok"], stats["v1"]["ok"],
                    sorted(stats["v2"]))
    assert got["port"] == got["ref"]
    assert got["port"][:3] == (0, 10, 30)


def test_coalesced_replies_equal_uncoalesced_at_the_bucket(tiers):
    """The port's balancer with ``fleet_coalesce_ms`` over the port's
    replicas, under concurrent requests of 1-3 rows: each reply is
    bit for bit a port ServeSession's rows for the request at a bucket of
    the ladder that could hold it (coalescing decides only the bucket),
    as every uncoalesced reply is, and merged forwards happen."""
    sink = MemorySink()
    bal = _balancer(pfleet, tiers.snap, tiers.port.reps,
                    extra=[("fleet_coalesce_ms", "30"),
                           ("fleet_coalesce_rows", "12")],
                    monitor=Monitor(sink))
    sess = ServeSession(parse_config(MLP_CONF) + [("dev", "cpu")],
                        model_path=tiers.snap, device="cpu")
    try:
        ladder = tuple(sess.engine.buckets)
        pool = np.random.RandomState(11).rand(32, 64).astype(np.float32)
        refs = {}
        for b in ladder:
            parts = []
            for i in range(0, len(pool), b):
                chunk = pool[i:i + b]
                k = len(chunk)
                pad = np.concatenate([chunk, np.zeros((b - k, 64),
                                                      np.float32)])
                parts.append(np.asarray(sess.predict(pad))[:k])
            refs[b] = np.concatenate(parts)
        replies = {"coalesced": [], "plain": []}
        lock = threading.Lock()

        def client(ci, b, kind):
            rng = np.random.RandomState(ci)
            for _ in range(6):
                n = int(rng.randint(1, 4))
                s = int(rng.randint(0, len(pool) - n + 1))
                st, out, _ = b.handle("", "gold", pool[s:s + n])
                with lock:
                    replies[kind].append((st, s, n, np.asarray(out)))

        for kind, b in (("coalesced", bal), ("plain", tiers.port.bal)):
            threads = [threading.Thread(target=client, args=(i, b, kind))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        for kind, got in replies.items():
            assert len(got) == 48
            for st, s, n, out in got:
                assert st == "ok", (kind, st, out)
                assert any(np.array_equal(out.reshape(n, -1),
                                          refs[b][s:s + n])
                           for b in ladder if b >= n), (kind, s, n)
        merged = [r for r in sink.records if r["event"] == "fleet_batch"]
        assert merged and max(r["requests"] for r in merged) > 1
        assert max(r["rows"] for r in merged) <= 12 + 2
        assert validate_records(sink.records, strict=False) == []
    finally:
        sess.close()
        bal.close()


def test_zero_failures_across_replica_loss(tiers):
    """Hard-stop one of the port tier's replicas under concurrent HTTP
    and binary traffic: every request answered ok. Runs after the
    tests that count the tier's requests; the lost replica is rebuilt."""
    t = tiers.port
    rows = np.random.RandomState(1).rand(2, 64).astype(np.float32)
    stop = threading.Event()
    fails, oks = [], [0] * 4
    lock = threading.Lock()

    def bin_client(ci):
        bc = pf.BinaryClient("127.0.0.1", t.bal.binary_port)
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
            code, body, _ = _http(t.bal.http_port, "POST", "/v1/predict",
                                  json.dumps({"tenant": "gold",
                                              "rows": rows.tolist()}))
            with lock:
                if code == 200:
                    oks[ci] += 1
                else:
                    fails.append((code, body))

    threads = [threading.Thread(target=bin_client, args=(i,))
               for i in range(2)]
    threads += [threading.Thread(target=http_client, args=(i,))
                for i in range(2, 4)]
    for th in threads:
        th.start()
    try:
        time.sleep(0.4)
        t.reps[0].close(drain=False)
        time.sleep(0.8)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert fails == [], fails[:5]
    assert sum(oks) > 50
    routes = [r for r in t.sink.records if r["event"] == "fleet_route"]
    assert {r["protocol"] for r in routes} == {"http", "binary"}
    assert validate_records(t.sink.records, strict=False) == []
    t.bal.remove_replica("r0")
    t.reps[0] = _replica("port", tiers.snap)
    t.bal.add_replica("r0", "127.0.0.1", t.reps[0].http_port,
                      t.reps[0].binary_port, "v1")


def test_mixed_tier(tiers):
    """The port's balancer in front of a reference replica, the
    reference's in front of a port replica: both serve every protocol
    with the reference tier's rows. A reference door and a port door
    over those two replicas, peered: each first-hand polls its own
    partition slice and learns the other replica from the other
    package's ``/fleet/view``."""
    rows = np.random.RandomState(4).rand(3, 64).astype(np.float32)
    want = _predict("cxn1", "ref", 0, tiers.ref.bal.binary_port, rows)[1]
    made = []
    try:
        crossed = {}
        for fleet, rep in ((pfleet, tiers.ref.reps[0]),
                           (rfleet, tiers.port.reps[1])):
            bal = _balancer(fleet, tiers.snap, [rep])
            made.append(bal)
            crossed[fleet.__name__] = bal
            for proto, client in (("http", "-"), ("cxn1", "port"),
                                  ("cxn2", "ref")):
                st, out, _ = _predict(proto, client, bal.http_port,
                                      bal.binary_port, rows)
                assert st == "ok", (fleet.__name__, proto)
                np.testing.assert_allclose(out, want, atol=ATOL, rtol=RTOL)
        doors = []
        for i, fleet in enumerate((rfleet, pfleet)):
            pairs = [("model_in", tiers.snap), ("fleet_http_port", "0"),
                     ("fleet_binary_port", "0"), ("fleet_balancers", "2"),
                     ("fleet_balancer_id", "b%d" % i),
                     ("fleet_balancer_index", str(i)),
                     ("fleet_health_poll_s", "0.1"),
                     ("fleet_gossip_s", "0.1")]
            bal = fleet.FleetBalancer(fleet.FleetTierConfig(pairs), pairs)
            bal.start()
            made.append(bal)
            for j, rep in enumerate((tiers.ref.reps[0], tiers.port.reps[1])):
                bal.add_replica("r%d" % j, "127.0.0.1", rep.http_port,
                                rep.binary_port, "v1")
            doors.append(bal)
        doors[0].set_tier_peers([("b1", "127.0.0.1", doors[1].http_port)])
        doors[1].set_tier_peers([("b0", "127.0.0.1", doors[0].http_port)])
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            srcs = []
            for bal in doors:
                with bal._lock:
                    srcs.append({r.replica_id: r.health_src
                                 for r in bal._reps.values()})
            if srcs == [{"r0": "poll", "r1": "gossip"},
                        {"r0": "gossip", "r1": "poll"}]:
                break
            time.sleep(0.05)
        assert srcs == [{"r0": "poll", "r1": "gossip"},
                        {"r0": "gossip", "r1": "poll"}]
        for bal in doors:
            assert bal.health_snapshot()["ready"] == 2
        views = [_http(b.http_port, "GET", "/fleet/view")[1] for b in doors]
        assert [v["balancer"] for v in views] == ["b0", "b1"]
        assert _keys(views[1], 1) == _keys(views[0], 1)
        for door in doors:
            st, out, _ = _predict("cxn1", "port", 0, door.binary_port, rows)
            assert st == "ok"
            np.testing.assert_allclose(out, want, atol=ATOL, rtol=RTOL)
    finally:
        # side by side: each close waits out its listeners' poll
        closers = [threading.Thread(target=bal.close) for bal in made]
        for t in closers:
            t.start()
        for t in closers:
            t.join(timeout=60)
