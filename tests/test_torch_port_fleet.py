"""The port's serving front end (``cxxnet_tpu_torch/serve``: frontend,
router, quota, swap) against the reference's (``cxxnet_tpu/serve``).

One reference snapshot of ``tests/test_fleet.py``'s MLP and one of a
narrow conv + BN net (``bn_fold_eval``, ``conv_pallas_epilogue``: the
conv_epilogue plain path runs) are served, at the bucket ladder ``1,4``,
by one reference ``FleetServer`` and one port ``FleetServer`` (``dev =
cpu``). The same requests go to both over HTTP, CXN1 and CXN2, with
each package's clients against each server: the status names, HTTP
codes, JSON keys, error messages and ``Retry-After`` are the same, and
the ok rows agree within atol 1e-5 / rtol 1e-4, the tolerance
``tests/test_torch_port_serve.py::test_serve_session_matches_jax``
holds (f32 sums in another order: oneDNN here, XLA there). Frames are
compared byte for byte; quotas and routers step by step on an injected
clock.
"""

import http.client
import io
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cxxnet_tpu.serve.frontend as rf
import cxxnet_tpu.serve.quota as rquota
import cxxnet_tpu_torch.serve.frontend as pf
import cxxnet_tpu_torch.serve.quota as pquota
from cxxnet_tpu.nnet.checkpoint import (read_snapshot as ref_read,
                                        write_snapshot as ref_write)
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.parallel import make_mesh
from cxxnet_tpu.serve import ModelRouter as RefRouter
from cxxnet_tpu.serve import ServeSession as RefSession
from cxxnet_tpu.serve import swap as rswap
from cxxnet_tpu.utils.config import parse_config
from cxxnet_tpu_torch.artifact import ResidencyBudgetError
from cxxnet_tpu_torch.monitor import MemorySink, Monitor
from cxxnet_tpu_torch.monitor.schema import validate_records
from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot, write_snapshot
from cxxnet_tpu_torch.serve import ModelRouter, ServeSession
from cxxnet_tpu_torch.serve import swap as pswap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4

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

CONV_CONF = """
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
  no_bias = 1
layer[1->2] = batch_norm:bn1
layer[2->3] = relu
layer[3->4] = max_pooling
  kernel_size = 2
  stride = 2
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 4
layer[6->6] = softmax
netconfig=end
input_shape = 3,8,8
batch_size = 4
"""
KNOBS = [("bn_fold_eval", "1"), ("bn_fuse_relu", "1"),
         ("conv_pallas_epilogue", "1")]
# the fleets' shared globals: the routed models' nets come from their
# snapshots. The budget (MB) holds both models in either package (their
# resident bytes: 7556 in the reference, 8420 in the port) and not a
# third MLP (4432 more)
FLEET_GLOBALS = [("batch_size", "4"), ("serve_buckets", "1,4"),
                 ("serve_max_delay_ms", "20"), ("serve_queue_rows", "4096"),
                 ("serve_quota", "free:5:2"),
                 ("serve_device_mem_budget", "0.01")] + KNOBS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_snapshot(conf, path, seed=0, extra=()):
    """A reference trainer's initial snapshot; a BN net gets running
    statistics a served fold can use (zeros would fold to ~1e5)."""
    t = RefTrainer(parse_config(conf) + [("seed", str(seed))]
                   + list(extra), mesh=make_mesh(1, 1))
    t.init_model()
    t.save_model(str(path))
    arrays, meta = ref_read(str(path))
    rng = np.random.RandomState(seed + 5)
    for k in list(arrays):
        if k.endswith("/running_exp"):
            arrays[k] = (0.1 * rng.rand(*arrays[k].shape)).astype(
                np.float32)
        if k.endswith("/running_var"):
            arrays[k] = (0.5 + rng.rand(*arrays[k].shape)).astype(
                np.float32)
    meta = {k: v for k, v in meta.items() if k != "content_digest"}
    ref_write(str(path), arrays, meta, fsync=False)


def _perturbed(src, dst, seed=7):
    """A newer snapshot through the port's checkpoint layer: every
    parameter scaled and shifted by seeded noise."""
    arrays, meta = read_snapshot(src)
    rng = np.random.RandomState(seed)
    for k in list(arrays):
        if k.startswith("param/"):
            a = arrays[k]
            arrays[k] = (a * 1.5 + 0.05 * rng.randn(*a.shape)).astype(
                a.dtype)
    meta = {k: v for k, v in meta.items() if k != "content_digest"}
    write_snapshot(dst, arrays, meta, fsync=False)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_snaps")
    mlp, conv = d / "mlp.model.npz", d / "conv.model.npz"
    _ref_snapshot(MLP_CONF, mlp)
    _ref_snapshot(CONV_CONF, conv, extra=KNOBS)
    return {"mlp": str(mlp), "conv": str(conv), "dir": d}


def _model_dirs(root, snaps):
    out = {}
    for m in ("mlp", "conv"):
        d = root / m
        d.mkdir(parents=True)
        shutil.copy(snaps[m], str(d / "0001.model.npz"))
        out[m] = str(d)
    return out


def _fleet_cfg(dirs, poll="0.05"):
    return FLEET_GLOBALS + [
        ("dev", "cpu"),
        ("serve_models", "main=%s;conv=%s|1,4" % (dirs["mlp"],
                                                  dirs["conv"])),
        ("serve_http_port", "0"), ("serve_binary_port", "0"),
        ("serve_swap_poll_s", poll)]


@pytest.fixture(scope="module")
def fleets(snaps, tmp_path_factory):
    """A reference and a port FleetServer over copies of the same two
    snapshots; the port's stream goes to a MemorySink."""
    root = tmp_path_factory.mktemp("fleets")
    ref_dirs = _model_dirs(root / "ref", snaps)
    port_dirs = _model_dirs(root / "port", snaps)
    ref = rf.FleetServer(_fleet_cfg(ref_dirs, poll="0"))
    sink = MemorySink()
    try:
        port = pf.FleetServer(_fleet_cfg(port_dirs), monitor=Monitor(sink))
    except BaseException:
        ref.close()
        raise
    ref.start()
    port.start()
    yield SimpleNamespace(ref=ref, port=port, sink=sink,
                          port_dirs=port_dirs)
    port.close()
    ref.close()


def _rows(seed, n, shape):
    return np.random.RandomState(seed).rand(n, *shape).astype(np.float32)


MLP_ROW, CONV_ROW = (64,), (8, 8, 3)


# -- frames ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["request", "request_v2", "reply_ok",
                                  "reply_err", "reply_v2_ok",
                                  "reply_v2_err", "pong", "ping"])
def test_frames_identical_bytes_both_ways(kind):
    rows = _rows(11, 3, (4,))

    def frame(mod):
        return {
            "request": lambda: mod.pack_request("m", "tenant", rows, 5.0),
            "request_v2": lambda: mod.pack_request_v2(
                9, "m#embed", "t", rows, 2.5),
            "reply_ok": lambda: mod.pack_reply(mod.STATUS_OK,
                                               payload=rows * 2),
            "reply_err": lambda: mod.pack_reply(
                mod.STATUS_UNKNOWN_MODEL, message="unknown model 'x'"),
            "reply_v2_ok": lambda: mod.pack_reply_v2(
                42, mod.STATUS_OK, payload=rows),
            "reply_v2_err": lambda: mod.pack_reply_v2(
                7, mod.STATUS_BUSY, message="busy now"),
            "pong": lambda: mod.pack_reply_v2(3, mod.STATUS_OK),
            "ping": lambda: mod.pack_ping_v2(5),
        }[kind]()

    a, b = frame(rf), frame(pf)
    assert a == b
    if kind.startswith("reply") or kind == "pong":
        # each package reads the other's frames
        for reader, data in ((pf, a), (rf, b)):
            got = reader.read_reply_tagged(io.BytesIO(data))
            want = rf.read_reply_tagged(io.BytesIO(data))
            assert got[:2] == want[:2]
            if isinstance(want[2], np.ndarray):
                np.testing.assert_array_equal(got[2], want[2])
            else:
                assert got[2] == want[2]
            if not kind.startswith("reply_v2") and kind != "pong":
                assert reader.read_reply(io.BytesIO(data))[0] == want[1]


def test_frame_constants_and_errors_match():
    for name in ("BIN_MAGIC", "BIN_MAGIC_V2", "MAX_FRAME_ROWS",
                 "MAX_FRAME_BYTES", "STATUS_NAMES", "STATUS_CODES",
                 "HTTP_STATUS", "SERVE_OPS"):
        assert getattr(pf, name) == getattr(rf, name), name
    for mod in (rf, pf):
        with pytest.raises(ValueError, match="255 bytes"):
            mod.pack_request("m" * 300, "t", np.zeros((1, 2), np.float32))
        with pytest.raises(IOError, match="bad reply magic"):
            mod.read_reply(io.BytesIO(b"XXXX" + bytes(12)))
    for spec in ("m", "m#embed", "m#search:5", "m#fsearch", "m#bogus",
                 "m#search:0", "m#search:x"):
        outs = []
        for mod in (rf, pf):
            try:
                outs.append(("ok", mod.parse_model_op(spec)))
            except ValueError as e:
                outs.append(("ValueError", str(e)))
        assert outs[0] == outs[1], spec


# -- quota and router, step by step on an injected clock -----------------


QUOTA_CASES = {
    "policies": ([("serve_quota", "free:100:2,vip:0"),
                  ("serve_quota_default", "1000:3")],
                 [("free", 2), ("free", 2), ("vip", 10), ("vip", 10),
                  ("a", 3), ("b", 3), ("a", 3), 0.01, ("free", 1),
                  ("a", 3)]),
    "long_idle": ([("serve_quota", "t:10:20")],
                  [("t", 20), ("t", 1), 3600.0, ("t", 20), ("t", 1)]),
    "partial_refill": ([("serve_quota", "t:10:20")],
                       [("t", 20), 0.5, ("t", 5), ("t", 5)]),
    "backwards_clock": ([("serve_quota", "t:100:10")],
                        [("t", 10), -50.0, ("t", 1), 50.0, ("t", 1),
                         0.05, ("t", 5), ("t", 1)]),
    "blank_unset": ([("serve_quota", "free:1:1"),
                     ("serve_quota_default", "1:1"), ("serve_quota", ""),
                     ("serve_quota_default", " ")],
                    [("free", 100), ("free", 100), ("anyone", 100)]),
    "oversized": ([("serve_quota", "t:10:4")],
                  [("t", 100), ("t", 100), 1.0, ("t", 4), ("t", 1)]),
    "zero_rate": ([("serve_quota", "vip:0"), ("serve_quota_default", "0")],
                  [("vip", 10 ** 6), ("anyone", 10 ** 6)]),
}


def _run_quota(mod, cfg, steps, monkeypatch):
    clock = SimpleNamespace(t=1000.0)
    monkeypatch.setattr(mod, "time",
                        SimpleNamespace(monotonic=lambda: clock.t))
    q = mod.QuotaManager(cfg)
    trace = []
    for s in steps:
        if isinstance(s, float):
            clock.t += s
            continue
        try:
            q.admit(*s)
            trace.append(("ok",) + s)
        except mod.TenantQuotaError as e:
            trace.append(("shed", e.tenant, e.rows, e.rate, e.burst,
                          round(e.retry_after_s, 9), str(e)))
    return trace, q.snapshot(), sorted(q._buckets)


@pytest.mark.parametrize("case", sorted(QUOTA_CASES))
def test_quota_same_admit_and_shed_sequence(case, monkeypatch):
    cfg, steps = QUOTA_CASES[case]
    ref = _run_quota(rquota, cfg, steps, monkeypatch)
    port = _run_quota(pquota, cfg, steps, monkeypatch)
    assert port == ref
    assert any(t[0] == "shed" for t in ref[0]) or case in (
        "blank_unset", "zero_rate")


@pytest.mark.parametrize("spec", [
    [("serve_quota", "free")], [("serve_quota", "free:-1")],
    [("serve_quota", "free:10:0")], [("serve_quota_default", "10:-5")],
    [("serve_quota", ":5")], [("serve_quota", "x:y")]])
def test_quota_bad_specs_raise_alike(spec):
    errs = []
    for mod in (rquota, pquota):
        with pytest.raises(ValueError) as e:
            mod.QuotaManager(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_token_bucket_and_shed_error_types_match():
    from cxxnet_tpu_torch.serve import ServeBusyError
    e = pquota.TenantQuotaError("t", 4, 10.0, 20.0, 0.4)
    assert isinstance(e, ServeBusyError)
    assert str(e) == str(rquota.TenantQuotaError("t", 4, 10.0, 20.0, 0.4))
    for mod in (rquota, pquota):
        for args in ((0.0, 1.0), (1.0, 0.0)):
            with pytest.raises(ValueError):
                mod.TokenBucket(*args)
        b = mod.TokenBucket(10.0, 4.0)
        b.reconfigure(10.0, 2.0)
        assert b.available() <= 2.0


class _FakeSession:
    """A session as the routers see it: ``close`` and, for the budget,
    the resident bytes in each package's accounting."""

    def __init__(self, nbytes=0):
        self.closed = None
        self.engine = SimpleNamespace(trainer=SimpleNamespace(
            residency={"bytes": nbytes},
            programs=SimpleNamespace(
                residency=SimpleNamespace(total_bytes=nbytes))))

    def close(self, drain=True):
        self.closed = drain
        return {"requests": 7, "compile_events": 0}


def _router_script(router_cls, budget_err):
    r = router_cls(mem_budget_bytes=170)
    s = {k: _FakeSession(n) for k, n in
         (("a", 100), ("b", 100), ("c", 120), ("d", 200), ("e", 40))}
    out = []

    def step(name, fn):
        try:
            res = fn()
            out.append((name, "ok", res))
        except budget_err as e:
            out.append((name, "ResidencyBudgetError", str(e)))
        except (KeyError, ValueError, RuntimeError) as e:
            out.append((name, type(e).__name__, str(e)))

    step("register a", lambda: r.register("main", s["a"], 1, "p1")
         .resident_bytes)
    step("dup", lambda: r.register("main", s["a"]).model_id)
    step("register b over", lambda: r.register("alt", s["b"], 1, "q"))
    step("register e", lambda: r.register("alt", s["e"], 1, "q")
         .resident_bytes)
    step("default", lambda: r.default_id)
    step("resolve ''", lambda: r.resolve("").model_id)
    step("resolve ghost", lambda: r.resolve("ghost"))
    step("swap c", lambda: r.swap("main", s["c"], 2, "p2").counter)
    step("swap d over", lambda: r.swap("main", s["d"], 3, "p3"))
    step("after", lambda: (r.resolve("main").session is s["c"],
                           r.resolve("main").generation,
                           r.resident_bytes_total()))
    step("swap ghost", lambda: r.swap("ghost", s["d"], 1, ""))
    step("describe", lambda: r.describe())
    step("close", lambda: r.close_all())
    step("close again", lambda: r.close_all())
    step("swap closed", lambda: r.swap("main", s["a"], 4, "p4"))
    step("closed", lambda: (s["c"].closed, s["e"].closed, s["a"].closed))
    return out


def test_router_same_answers_and_budget():
    from cxxnet_tpu.artifact.registry import \
        ResidencyBudgetError as RefBudgetError
    ref = _router_script(RefRouter, RefBudgetError)
    port = _router_script(ModelRouter, ResidencyBudgetError)
    assert port == ref
    assert [o[1] for o in port].count("ResidencyBudgetError") == 2


# -- config and sources ---------------------------------------------------


FLEET_SPECS = [
    [("serve_models", "main=./m1;alt=s3://bucket/m2|1,8"),
     ("serve_http_port", "0"), ("serve_binary_port", "-1"),
     ("serve_swap_poll_s", "0.5"), ("serve_fleet_duration_s", "2"),
     ("serve_host", "0.0.0.0"), ("serve_port_file", "ports.json"),
     ("serve_device_mem_budget", "512")],
    [("serve_models", "a=./x, b=./y")],
    [("model_dir", "./models")],
    [("model_in", "snap.model.npz"), ("model_dir", "./m")],
    [("serve_models", "a=./x,a=./y")],
    [("serve_models", "nodir")],
    [("serve_models", "=./x")],
    [("serve_http_port", "-1"), ("serve_binary_port", "-1")],
]


@pytest.mark.parametrize("spec", FLEET_SPECS,
                         ids=["full", "comma", "model_dir", "model_in",
                              "dup", "no_source", "no_id", "no_protocol"])
def test_fleet_config_parses_alike(spec):
    outs = []
    for mod in (rf, pf):
        try:
            c = mod.FleetConfig(spec)
            outs.append((c.models, c.http_port, c.binary_port, c.host,
                         c.swap_poll_s, c.duration_s, c.mem_budget_mb,
                         c.port_file))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]


def test_sources_scan_alike_and_touch_nothing(snaps, tmp_path):
    d = tmp_path / "models"
    d.mkdir()
    assert pswap.latest_verified(str(d)) == (None, None) == \
        rswap.latest_verified(str(d))
    shutil.copy(snaps["mlp"], str(d / "0001.model.npz"))
    (d / "0002.model.npz").write_bytes(b"torn garbage")
    (d / "0003.model.npz.tmp").write_bytes(b"in-flight")
    before = sorted(os.listdir(str(d)))
    got = pswap.latest_verified(str(d))
    assert got == rswap.latest_verified(str(d))
    assert got[0] == 1 and got[1].endswith("0001.model.npz")
    assert pswap.latest_verified(str(d), min_counter=1) == (None, None)
    assert sorted(os.listdir(str(d))) == before      # read-only
    for name in ("/x/0042.model.npz", "/x/custom.npz",
                 "/x/0007.model.bundle/", "0001.model.npz"):
        assert pswap.counter_of(name) == rswap.counter_of(name)
    pinned = str(d / "0001.model.npz")
    assert pf.FleetServer._resolve_source(pinned) == \
        rf.FleetServer._resolve_source(pinned) == (1, pinned, "")
    assert pf.FleetServer._resolve_source(str(d)) == \
        rf.FleetServer._resolve_source(str(d))
    with pytest.raises(FileNotFoundError):
        pf.FleetServer._resolve_source(str(tmp_path / "empty"))


def _bundle(d, counter, committed=True):
    b = d / ("%04d.model.bundle" % counter)
    b.mkdir()
    (b / "MANIFEST.json").write_text("{}")
    if committed:
        (b / "MANIFEST.json.ok").write_text("{}")
    return str(b)


def _export(snap, out):
    """The port's export of ``snap`` (on the CPU: no kernel library)."""
    from cxxnet_tpu_torch.artifact.bundle import export_bundle
    from cxxnet_tpu_torch.serve import build_engine
    engine = build_engine(FLEET_GLOBALS, snap, buckets="1,4",
                          device="cpu")
    engine.warmup()
    return export_bundle(engine, out)


def test_bundle_sources_boot_and_win_at_equal_counter(snaps, tmp_path):
    """A bundle beside the snapshot of its counter wins, in both
    packages' scans; an uncommitted one is not seen; a pinned bundle
    source boots and serves its snapshot's rows."""
    d = tmp_path / "models"
    d.mkdir()
    shutil.copy(snaps["mlp"], str(d / "0001.model.npz"))
    _bundle(d, 2, committed=False)          # still being written
    assert pf.FleetServer._resolve_source(str(d))[0] == 1
    b = str(d / "0001.model.bundle")
    assert _export(str(d / "0001.model.npz"), b)["programs"] == 0
    got = pf.FleetServer._resolve_source(str(d))
    assert got == rf.FleetServer._resolve_source(str(d)) == (1, b, str(d))
    assert pf.FleetServer._resolve_source(b) == \
        rf.FleetServer._resolve_source(b) == (1, b, "")
    rows = _rows(3, 3, MLP_ROW)
    sink = MemorySink()
    outs = []
    for path, mon in ((b, Monitor(sink)), (str(d / "0001.model.npz"),
                                           None)):
        s = ServeSession(FLEET_GLOBALS + [("dev", "cpu")],
                         model_path=path, monitor=mon, device="cpu")
        try:
            outs.append(s.predict(rows))
        finally:
            s.close()
    np.testing.assert_array_equal(outs[0], outs[1])
    (art,) = [r for r in sink.records if r["event"] == "artifact_load"]
    assert art["fingerprint_match"] and art["hits"] == 0 \
        and art["rebuilds"] == 0


def test_watcher_skips_a_bundle_and_keeps_serving_snapshots(snaps,
                                                            tmp_path):
    """A committed bundle that fails verification is skipped (its
    manifest is no manifest), as the reference's scan skips it; a newer
    snapshot still swaps in, a failed build keeps the old one."""
    d = tmp_path / "models"
    d.mkdir()
    shutil.copy(snaps["mlp"], str(d / "0001.model.npz"))
    router = ModelRouter()
    router.register("main", _FakeSession(), 1, str(d / "0001.model.npz"))
    sink = MemorySink()
    built = []

    def builder(path):
        if path.endswith("0004.model.npz"):
            raise IOError("cannot build")
        built.append(path)
        return _FakeSession()

    w = pswap.SnapshotWatcher(router, "main", str(d), builder,
                              monitor=Monitor(sink))
    assert w.check_once() is None
    _bundle(d, 5)
    assert w.check_once() is None and w.check_once() is None
    shutil.copy(snaps["mlp"], str(d / "0002.model.npz"))
    rec = w.check_once()
    assert rec["old_counter"] == 1 and rec["new_counter"] == 2
    assert router.resolve("main").counter == 2 and w.swaps == 1
    shutil.copy(snaps["mlp"], str(d / "0004.model.npz"))
    assert w.check_once() is None and w.failed_builds == 1
    assert router.resolve("main").counter == 2
    codes = [r["code"] for r in sink.records if r["event"] == "warning"]
    assert not any("0005.model.bundle" in c for c in codes)
    assert rswap.latest_verified(str(d)) == pswap.latest_verified(str(d))
    assert "hot_swap_build_failed:%s" % (d / "0004.model.npz") in codes
    assert [r["event"] for r in sink.records].count("hot_swap") == 1


# -- the wire, both servers ----------------------------------------------


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        try:
            obj = json.loads(raw)
        except ValueError:
            obj = raw
        return r.status, obj, dict(r.getheaders())
    finally:
        conn.close()


def _same_reply(a, b):
    """(status, rows | message) of two servers: same status; rows within
    the tolerance, messages equal."""
    assert a[0] == b[0], (a, b)
    if isinstance(a[1], np.ndarray):
        assert a[1].shape == b[1].shape
        np.testing.assert_allclose(b[1], a[1], atol=ATOL, rtol=RTOL)
    else:
        assert a[1] == b[1]


HTTP_CASES = [
    ("POST", "/v1/predict", {"model": "main", "tenant": "g",
                             "rows": ("mlp", 3)}),
    ("POST", "/v1/predict", {"model": "conv", "rows": ("conv", 4)}),
    ("POST", "/v1/predict", {"rows": ("mlp", 1)}),
    ("POST", "/v1/embed", {"model": "main", "rows": ("mlp", 2)}),
    ("POST", "/v1/predict", {"model": "ghost", "rows": ("mlp", 1)}),
    ("POST", "/v1/predict", {"model": "main", "rows": [[1.0, 2.0]]}),
    ("POST", "/v1/predict", "not json"),
    ("POST", "/v1/predict", {"model": "main"}),
    ("POST", "/v1/predict", {"model": "main", "rows": ("mlp", 5)}),
    ("POST", "/v1/search", {"model": "main", "rows": ("mlp", 1)}),
    ("POST", "/v1/search", {"model": "main", "rows": ("mlp", 1),
                            "fan_out": 1, "k": 3}),
    ("POST", "/v1/predict", {"model": "main#bogus", "rows": ("mlp", 1)}),
    ("POST", "/v2/nothing", {}),
    ("GET", "/nothing", None),
]


def _body(spec, seed):
    if spec is None or isinstance(spec, str):
        return spec
    out = dict(spec)
    if isinstance(out.get("rows"), tuple):
        kind, n = out["rows"]
        out["rows"] = _rows(seed, n, MLP_ROW if kind == "mlp"
                            else CONV_ROW).reshape(n, -1).tolist()
    return json.dumps(out)


@pytest.mark.parametrize("i", range(len(HTTP_CASES)))
def test_http_answers_match(fleets, i):
    method, path, spec = HTTP_CASES[i]
    body = _body(spec, 100 + i)
    a = _http(fleets.ref.http_port, method, path, body)
    b = _http(fleets.port.http_port, method, path, body)
    assert a[0] == b[0], (a, b)
    assert sorted(a[1]) == sorted(b[1]), (a, b)
    if "result" in a[1]:
        assert a[1]["rows"] == b[1]["rows"]
        assert a[1]["model"] == b[1]["model"]
        np.testing.assert_allclose(np.array(b[1]["result"]),
                                   np.array(a[1]["result"]), atol=ATOL,
                                   rtol=RTOL)
    else:
        assert a[1] == b[1]


def test_http_introspection_matches(fleets):
    a = _http(fleets.ref.http_port, "GET", "/v1/models")[1]["models"]
    b = _http(fleets.port.http_port, "GET", "/v1/models")[1]["models"]
    assert [sorted(m) for m in a] == [sorted(m) for m in b]
    for ma, mb in zip(a, b):
        for k in ("model", "counter", "generation", "max_batch",
                  "row_elems", "instance_shape", "buckets", "bundle"):
            assert ma[k] == mb[k], k
        assert len(mb["fingerprint_sha256"]) == 16
        assert mb["fingerprint_sha256"] != ma["fingerprint_sha256"]
    ha = _http(fleets.ref.http_port, "GET", "/healthz")[1]
    hb = _http(fleets.port.http_port, "GET", "/healthz")[1]
    assert sorted(ha) == sorted(hb)
    assert ha["models"] == hb["models"] == ["main", "conv"]
    assert [sorted(m) for m in ha["model_health"]] == \
        [sorted(m) for m in hb["model_health"]]
    assert hb["resident_bytes"] == \
        fleets.port.router.resident_bytes_total() < 10000


def test_over_quota_answers_match(fleets):
    """The 5 rows/s, 2-row-burst tenant: its first 2-row request is
    admitted, the next shed with 429, the typed body and Retry-After;
    the seconds in the message are timing, the rest is the same."""
    outs = []
    for srv in (fleets.ref, fleets.port):
        body = _body({"model": "main", "tenant": "free",
                      "rows": ("mlp", 2)}, 7)
        first = _http(srv.http_port, "POST", "/v1/predict", body)
        shed = _http(srv.http_port, "POST", "/v1/predict", body)
        bc = srv_client(srv)
        try:
            binary = bc.predict(_rows(7, 2, MLP_ROW), model="main",
                                tenant="free")
        finally:
            bc.close()
        outs.append((first, shed, binary))
    (fa, sa, ba), (fb, sb, bb) = outs
    assert fa[0] == fb[0] == 200
    assert sa[0] == sb[0] == 429
    assert sorted(sa[1]) == sorted(sb[1]) == ["error", "message",
                                               "retry_after_s"]
    assert sa[1]["error"] == sb[1]["error"] == "over_quota"
    assert sa[2]["Retry-After"] == sb[2]["Retry-After"]
    assert abs(sa[1]["retry_after_s"] - sb[1]["retry_after_s"]) < 0.3
    strip = lambda m: re.sub(r"retry in [0-9.]+s", "retry in ?s", m)
    assert strip(sa[1]["message"]) == strip(sb[1]["message"])
    assert ba[0] == bb[0] == "over_quota"
    assert strip(ba[1]) == strip(bb[1])


def srv_client(srv, mod=None):
    return (mod or pf).BinaryClient("127.0.0.1", srv.binary_port)


BINARY_CASES = [("main", "g", "mlp", 3), ("conv", "", "conv", 4),
                ("", "", "mlp", 1), ("main#embed", "", "mlp", 2),
                ("ghost", "", "mlp", 1), ("main", "", "conv", 1),
                ("main#search", "", "mlp", 1), ("conv#fsearch:2", "",
                                                "conv", 1),
                ("main#search:0", "", "mlp", 1), ("main", "", "mlp", 5)]


@pytest.mark.parametrize("client", ["ref_client", "port_client"])
def test_binary_v1_answers_match_across_clients(fleets, client):
    """Each package's BinaryClient against both servers: the same
    answers."""
    mod = rf if client == "ref_client" else pf
    clients = [srv_client(s, mod) for s in (fleets.ref, fleets.port)]
    try:
        for j, (model, tenant, kind, n) in enumerate(BINARY_CASES):
            rows = _rows(200 + j, n, MLP_ROW if kind == "mlp" else CONV_ROW)
            a, b = (c.predict(rows.reshape(n, -1), model=model,
                              tenant=tenant) for c in clients)
            _same_reply(a, b)
    finally:
        for c in clients:
            c.close()


def _v2_exchange(port):
    """On one connection: v1, v2, v1 frames; a predict overtaken by a
    ping (the batch window is 20 ms); 8 pipelined v2 predicts."""
    rows = _rows(300, 2, MLP_ROW)
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    rfile = s.makefile("rb")
    out = []
    try:
        s.sendall(pf.pack_request("main", "", rows))
        out.append(pf.read_reply_tagged(rfile))
        s.sendall(rf.pack_request_v2(11, "main", "", rows))
        out.append(pf.read_reply_tagged(rfile))
        s.sendall(pf.pack_request("", "", rows))
        out.append(rf.read_reply_tagged(rfile))
        # one segment: the ping is read while the predict waits out
        # its batch window
        s.sendall(pf.pack_request_v2(7, "main", "", rows[:1])
                  + pf.pack_ping_v2(9))
        out.append(pf.read_reply_tagged(rfile))
        out.append(pf.read_reply_tagged(rfile))
        for i in range(8):
            s.sendall(pf.pack_request_v2(100 + i, "conv", "",
                                         _rows(400 + i, 1, CONV_ROW)))
        got = {}
        for _ in range(8):
            corr, status, res = pf.read_reply_tagged(rfile)
            got[corr] = (status, res)
        out.append(tuple(got[100 + i] for i in range(8)))
        s.sendall(pf.pack_request_v2(12, "ghost", "", rows))
        out.append(pf.read_reply_tagged(rfile))
    finally:
        rfile.close()
        s.close()
    return out


def test_v2_frames_match_and_reply_out_of_order(fleets):
    a, b = _v2_exchange(fleets.ref.binary_port), \
        _v2_exchange(fleets.port.binary_port)
    assert [x[0] for x in b[:5]] == [None, 11, None, 9, 7]
    for xa, xb in zip(a[:5] + a[6:], b[:5] + b[6:]):
        assert xa[0] == xb[0]
        _same_reply(xa[1:], xb[1:])
    for xa, xb in zip(a[5], b[5]):
        _same_reply(xa, xb)
    assert b[3][2].shape == (0, 0)          # the pong


@pytest.mark.parametrize("frame", ["rows", "bytes", "magic"])
def test_bad_frames_refused_alike(fleets, frame):
    """An oversized header or an unknown magic: a v1 bad_request frame
    with the same message, then the connection drops."""
    if frame == "rows":
        data = rf._REQ_HEADER.pack(rf.BIN_MAGIC, 0, 0,
                                   rf.MAX_FRAME_ROWS + 1, 1, 0.0)
    elif frame == "bytes":
        data = rf._REQ_HEADER_V2.pack(rf.BIN_MAGIC_V2, 3, 0, 0, 1 << 16,
                                      1 << 16, 0.0)
    else:
        data = b"HTTP" + bytes(20)
    outs = []
    for srv in (fleets.ref, fleets.port):
        s = socket.create_connection(("127.0.0.1", srv.binary_port),
                                     timeout=60)
        rfile = s.makefile("rb")
        try:
            s.sendall(data)
            outs.append(rf.read_reply_tagged(rfile))
            assert rfile.read(1) == b""               # dropped
        finally:
            rfile.close()
            s.close()
    assert outs[0] == outs[1]
    assert outs[0][1] == "bad_request"


def test_budget_rejects_at_the_router_and_the_engine(fleets, snaps):
    """A third model over ``serve_device_mem_budget``: the router
    raises ResidencyBudgetError in both packages and the served set
    keeps serving; an engine whose own model is over the budget fails
    its build with it (the reference's message) before serving."""
    from cxxnet_tpu.artifact.registry import \
        ResidencyBudgetError as RefBudgetError
    cfg = [("batch_size", "4"), ("serve_buckets", "1,4")]
    extra_p = ServeSession(cfg, model_path=snaps["mlp"], device="cpu")
    extra_r = RefSession(cfg, model_path=snaps["mlp"])
    try:
        for srv, sess, err in ((fleets.ref, extra_r, RefBudgetError),
                               (fleets.port, extra_p,
                                ResidencyBudgetError)):
            with pytest.raises(err, match="over serve_device_mem_budget"):
                srv.router.register("third", sess)
            assert srv.router.ids() == ["main", "conv"]
            code, body, _ = _http(srv.http_port, "POST", "/v1/predict",
                                  _body({"model": "conv",
                                         "rows": ("conv", 1)}, 5))
            assert code == 200 and body["rows"] == 1
    finally:
        extra_p.close()
        extra_r.close()
    tight = cfg + [("serve_device_mem_budget", "0.001")]
    msgs = []
    for cls, err, kw in ((RefSession, RefBudgetError, {}),
                         (ServeSession, ResidencyBudgetError,
                          {"device": "cpu"})):
        with pytest.raises(err) as e:
            cls(tight, model_path=snaps["mlp"], **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("model needs ~4432 resident bytes")


def test_fleet_boot_over_budget_raises_and_leaks_nothing(snaps):
    from cxxnet_tpu.artifact.registry import \
        ResidencyBudgetError as RefBudgetError
    cfg = [("batch_size", "4"), ("serve_buckets", "1,4"), ("dev", "cpu"),
           ("serve_models", "a=%s,b=%s" % (snaps["mlp"], snaps["mlp"])),
           ("serve_device_mem_budget", "0.006")]
    with pytest.raises(RefBudgetError, match="would put the fleet at 8864"):
        rf.FleetServer(cfg)
    # the reference leaves model a's session running; the port closes it
    threads = threading.active_count()
    with pytest.raises(ResidencyBudgetError,
                       match="would put the fleet at 8864"):
        pf.FleetServer(cfg)
    assert threading.active_count() == threads


def test_hot_swap_under_traffic_has_no_failed_request(fleets, snaps):
    """Threaded HTTP, CXN1 and CXN2 clients on the port's fleet while a
    perturbed snapshot commits into the watched directory: one
    ``hot_swap``, no failed request, and afterwards the rows are a
    session's on the new snapshot, bit for bit."""
    port, sink, dirs = fleets.port, fleets.sink, fleets.port_dirs
    pool = _rows(500, 16, MLP_ROW)
    stop = threading.Event()
    fails, oks = [], [0]
    lock = threading.Lock()

    def note(status, detail):
        with lock:
            if status == "ok":
                oks[0] += 1
            else:
                fails.append((status, detail))

    def http_client(ci):
        while not stop.is_set():
            rows = pool[ci:ci + 2]
            code, body, _ = _http(port.http_port, "POST", "/v1/predict",
                                  json.dumps({"model": "main",
                                              "rows": rows.tolist()}))
            note("ok" if code == 200 else code, body)

    def v1_client(ci):
        bc = srv_client(port)
        try:
            while not stop.is_set():
                st, res = bc.predict(pool[ci:ci + 3], model="main",
                                     tenant="t%d" % ci)
                note(st, res)
        finally:
            bc.close()

    def v2_client(ci):
        s = socket.create_connection(("127.0.0.1", port.binary_port),
                                     timeout=60)
        rfile = s.makefile("rb")
        try:
            corr = 0
            while not stop.is_set():
                for k in range(3):
                    s.sendall(pf.pack_request_v2(corr + k, "main", "",
                                                 pool[k:k + 1 + ci]))
                for _ in range(3):
                    _, st, res = pf.read_reply_tagged(rfile)
                    note(st, res)
                corr += 3
        finally:
            rfile.close()
            s.close()

    threads = [threading.Thread(target=f, args=(i,))
               for f in (http_client, v1_client, v2_client)
               for i in range(2)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        _perturbed(os.path.join(dirs["mlp"], "0001.model.npz"),
                   os.path.join(dirs["mlp"], "0002.model.npz"))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                r["event"] == "hot_swap" for r in sink.records):
            time.sleep(0.02)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    swaps = [r for r in sink.records if r["event"] == "hot_swap"]
    assert len(swaps) == 1 and swaps[0]["new_counter"] == 2
    assert fails == [] and oks[0] > 20
    entry = port.router.resolve("main")
    assert entry.counter == 2 and entry.generation == 1
    new = ServeSession(FLEET_GLOBALS, model_path=entry.path, device="cpu")
    bc = srv_client(port)
    try:
        for n in (1, 3, 4):
            st, got = bc.predict(pool[:n], model="main")
            assert st == "ok"
            np.testing.assert_array_equal(got, new.predict(pool[:n]))
    finally:
        bc.close()
        new.close()
    assert validate_records(sink.records, strict=False) == []
    kinds = {r["event"] for r in sink.records}
    assert {"serve_http", "tenant_shed", "hot_swap"} <= kinds


def test_serve_fleet_cli_serves_until_sigterm(snaps, tmp_path):
    """``python -m cxxnet_tpu_torch.main ... task=serve_fleet`` with
    ``serve_fleet_duration_s = 0`` (the deployment mode): it writes the
    port file, answers, and on SIGTERM drains and exits 0 with the
    reference's closing line."""
    d = tmp_path / "models"
    d.mkdir()
    shutil.copy(snaps["mlp"], str(d / "0001.model.npz"))
    conf = tmp_path / "fleet.conf"
    conf.write_text(MLP_CONF)
    ports = tmp_path / "ports.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", str(conf),
         "task=serve_fleet", "dev=cpu", "model_dir=%s" % d,
         "serve_http_port=0", "serve_binary_port=-1",
         "serve_swap_poll_s=0", "serve_fleet_duration_s=0",
         "serve_port_file=%s" % ports], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(tmp_path), env=env)
    try:
        deadline = time.monotonic() + 120
        while not ports.exists() and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ports.exists(), proc.communicate(timeout=30)
        doc = json.loads(ports.read_text())
        assert doc["pid"] == proc.pid and doc["binary_port"] == -1
        code, body, _ = _http(doc["http_port"], "POST", "/v1/predict",
                              json.dumps({"rows": _rows(1, 2, MLP_ROW)
                                          .tolist()}))
        assert code == 200 and body["rows"] == 2
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "serve_fleet: listening http=%d binary=-1, models: " \
        "default@0001" % doc["http_port"] in out
    assert "serve_fleet: 1 requests (1 ok / 0 over_quota / 0 busy / " \
        "0 timeout / 0 error), 0 hot-swaps" in out


def test_fleet_asks_for_the_gpu_unless_dev_is_cpu(snaps):
    """Without ``dev = cpu`` (or a ``device``) the fleet's sessions run
    on the GPU: here there is none, so the boot raises before a model
    loads."""
    assert not torch.cuda.is_available()
    cfg = [("batch_size", "4"), ("serve_models", "a=%s" % snaps["mlp"])]
    for extra in ([], [("dev", "gpu")], [("dev", "tpu")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pf.FleetServer(cfg + extra)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pf.FleetServer(cfg + [("dev", "cpu")], device="cuda")
