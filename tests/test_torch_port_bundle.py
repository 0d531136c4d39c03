"""The port's sealed bundles (``cxxnet_tpu_torch/artifact``) against the
reference's (``cxxnet_tpu/artifact``).

One reference snapshot of a narrow conv + BN net (``bn_fold_eval``,
``bn_fuse_relu``, ``conv_pallas_epilogue``: the conv_epilogue plain path
runs on the CPU) is exported by the reference's ``export_bundle`` on its
CPU engine (ladder ``1,4``), which seals its XLA executables:

- the port verifies that bundle and boots it (``build_engine`` and
  ``task = pred``) through the rebuild path (one
  ``artifact_fingerprint_mismatch`` warning, ``hits`` 0, ``rebuilds ==
  len(programs)``, no member unpickled), and its rows lie within rtol
  1e-5 / atol 1e-6 of the reference engine's on the same snapshot;
- a bundle the port writes passes the reference's ``verify_bundle`` and
  ``load_bundle``, and the reference boots it;
- tampered copies (a program byte, a torn snapshot, the marker, the
  manifest, ``fault://`` truncation) get the same ``verify_bundle``
  report from both packages, and both scans fall back to the snapshot;
- the kernel-library store installs, rebuilds and re-exports a synthetic
  library (a monkeypatched ``BUILD_DIR``; nothing is loaded);
- the watcher flips a served snapshot to the bundle of its counter.

The reference's own bundle *boot* fails in this container (its AOT
loader refuses the host's CPU features), so its boot is not the oracle
here; its export, verify and manifest code are.
"""

import hashlib
import http.client
import json
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch

from cxxnet_tpu.artifact import bundle as rb
from cxxnet_tpu.artifact import registry as rreg
from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.nnet.checkpoint import (read_snapshot as ref_read,
                                        write_snapshot as ref_write)
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.parallel import make_mesh
from cxxnet_tpu.retrieval import EmbeddingIndex as RefIndex
from cxxnet_tpu.retrieval import IndexError_ as RefIndexError
from cxxnet_tpu.serve import ServeSession as RefSession
from cxxnet_tpu.serve import build_engine as ref_build_engine
from cxxnet_tpu.serve import swap as rswap
from cxxnet_tpu.utils.config import parse_config
from cxxnet_tpu.utils.faultfs import FaultFS as RefFaultFS
from cxxnet_tpu_torch.artifact import bundle as pb
from cxxnet_tpu_torch.artifact import registry as preg
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.monitor import MemorySink, Monitor
from cxxnet_tpu_torch.serve import FleetServer, ServeSession, build_engine
from cxxnet_tpu_torch.serve import swap as pswap
from cxxnet_tpu_torch.retrieval import IndexError_ as PortIndexError
from cxxnet_tpu_torch.utils.faultfs import FaultFS
from cxxnet_tpu_torch.utils.stream import open_stream

RTOL, ATOL = 1e-5, 1e-6

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
         ("conv_pallas_epilogue", "1"), ("serve_buckets", "1,4")]
CFG = parse_config(CONV_CONF) + KNOBS
PORT_CFG = CFG + [("dev", "cpu")]
ROW = (8, 8, 3)
# the verify_bundle report fields both packages fill
REPORT = ("ok", "error", "members", "programs", "format_version",
          "committed")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(seed, n):
    return np.random.RandomState(seed).rand(n, *ROW).astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's snapshot (BN statistics a fold can use), its
    engine's rows, and its bundle of that snapshot."""
    d = tmp_path_factory.mktemp("bundle_ref")
    snap = str(d / "0001.model.npz")
    t = RefTrainer(CFG, mesh=make_mesh(1, 1))
    t.init_model()
    t.save_model(snap)
    arrays, meta = ref_read(snap)
    rng = np.random.RandomState(5)
    for k in list(arrays):
        if k.endswith("/running_exp"):
            arrays[k] = (0.1 * rng.rand(*arrays[k].shape)).astype(
                np.float32)
        if k.endswith("/running_var"):
            arrays[k] = (0.5 + rng.rand(*arrays[k].shape)).astype(
                np.float32)
    meta = {k: v for k, v in meta.items() if k != "content_digest"}
    ref_write(snap, arrays, meta, fsync=False)
    engine = ref_build_engine(CFG, snap, buckets=(1, 4), max_batch=4)
    engine.warmup(warm_run=False)
    bundle = str(d / "0001.model.bundle")
    stats = rb.export_bundle(engine, bundle)
    assert stats["programs"] > 0
    rows = _rows(7, 5)
    return {"dir": d, "snap": snap, "bundle": bundle, "rows": rows,
            "out": np.asarray(engine.run(rows))}


def _port_export(snap, out, libraries=()):
    """The port's export of ``snap`` on the CPU; ``libraries`` are put
    in the store as if the serve path had loaded them."""
    engine = build_engine(PORT_CFG, snap, buckets="1,4", device="cpu")
    engine.warmup()
    engine.trainer.programs.libraries.update(libraries)
    return engine, pb.export_bundle(engine, out)


def _report(rep):
    return {k: rep[k] for k in REPORT}


# -- across packages ------------------------------------------------------


def test_reference_bundle_boots_in_port_through_rebuild(ref, monkeypatch):
    """The port verifies the reference's bundle, boots it without
    unpickling a member (one mismatch warning, every program a rebuild)
    and serves the reference engine's rows."""
    rep = pb.verify_bundle(ref["bundle"])
    assert _report(rep) == _report(rb.verify_bundle(ref["bundle"]))
    assert rep["ok"] and rep["programs"] > 0

    def no_unpickle(*a, **k):
        raise AssertionError("a bundle member was unpickled")

    monkeypatch.setattr(pickle, "loads", no_unpickle)
    sink = MemorySink()
    engine = build_engine(PORT_CFG, ref["bundle"], device="cpu",
                          monitor=Monitor(sink))
    assert engine.buckets == (1, 4)
    engine.warmup()
    np.testing.assert_allclose(engine.run(ref["rows"]), ref["out"],
                               rtol=RTOL, atol=ATOL)
    warns = [r["code"] for r in sink.records if r["event"] == "warning"]
    assert warns == ["artifact_fingerprint_mismatch"]
    (art,) = [r for r in sink.records if r["event"] == "artifact_load"]
    assert not art["fingerprint_match"]
    assert art["hits"] == 0 and art["rebuilds"] == rep["programs"]
    assert art["path"] == ref["bundle"]


def test_task_pred_from_reference_bundle(ref, tmp_path, monkeypatch):
    """``task = pred`` with the reference's bundle as ``model_in`` writes
    the file the reference's ``task = pred`` writes from its snapshot."""
    rows = _rows(11, 6)
    with open(str(tmp_path / "p.csv"), "w") as f:
        for r in rows:
            # CSV rows are (c, y, x) order; the iterator makes them NHWC
            f.write("0," + ",".join("%.7g" % v for v in
                                    r.transpose(2, 0, 1).ravel()) + "\n")
    conf = CONV_CONF + "".join("%s = %s\n" % kv for kv in KNOBS) + """
pred = pred.txt
iter = csv
  filename = p.csv
  input_shape = 3,8,8
  silent = 1
iter = end
"""
    with open(str(tmp_path / "c.conf"), "w") as f:
        f.write(conf)
    monkeypatch.chdir(tmp_path)
    assert RefTask().run(["c.conf", "task=pred", "model_in=" + ref["snap"],
                          "pred=ref.txt"]) == 0
    assert LearnTask().run(["c.conf", "dev=cpu", "task=pred",
                            "model_in=" + ref["bundle"],
                            "pred=port.txt", "monitor=jsonl",
                            "monitor_path=m.jsonl"]) == 0
    with open("ref.txt") as a, open("port.txt") as b:
        assert a.read() == b.read()
    recs = [json.loads(ln) for ln in open("m.jsonl") if ln.strip()]
    (art,) = [r for r in recs if r["event"] == "artifact_load"]
    assert art["hits"] == 0 and art["rebuilds"] > 0


def test_port_bundle_passes_reference_verify_load_and_boot(ref, tmp_path):
    out = str(tmp_path / "0001.model.bundle")
    _, stats = _port_export(ref["snap"], out)
    assert stats["programs"] == 0 and stats["members"] == 1
    rrep = rb.verify_bundle(out)
    assert rrep["ok"] and _report(rrep) == _report(pb.verify_bundle(out))
    man = rb.bundle_manifest(out)
    assert man["fingerprint"]["backend"] == "torch"
    assert man["buckets"] == [1, 4] and man["input_dtype"] == "float32"
    loaded = rb.load_bundle(out)
    assert loaded.snapshot_raw == pb.load_bundle(out).snapshot_raw
    assert rb.serve_cfg_from_bundle(out) == pb.serve_cfg_from_bundle(out)
    sess = RefSession(CFG, model_path=out)
    try:
        got = np.asarray(sess.predict(ref["rows"][:4]))
    finally:
        sess.close()
    np.testing.assert_allclose(got, ref["out"][:4], rtol=RTOL, atol=ATOL)


# -- tampering ------------------------------------------------------------


def _rewrite_manifest(b, edit):
    """Edit the manifest and rewrite its marker consistently."""
    manp = os.path.join(b, "MANIFEST.json")
    man = json.load(open(manp))
    edit(man)
    man_bytes = json.dumps(man, sort_keys=True, indent=1).encode()
    with open(manp, "wb") as f:
        f.write(man_bytes)
    with open(manp + ".ok", "w") as f:
        json.dump({"format_version": 1, "bytes": len(man_bytes),
                   "file_sha256": hashlib.sha256(man_bytes).hexdigest()}, f)


def _flip_prog(b):
    p = os.path.join(b, "prog-0000.pkl")
    data = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(data[:-32] + b"\0" * 32)    # same size, other bytes


def _tear_snapshot(b):
    p = os.path.join(b, pb.SNAPSHOT_MEMBER)
    data = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(data[:-8])


def _marker(text):
    def tamper(b):
        with open(os.path.join(b, "MANIFEST.json.ok"), "w") as f:
            f.write(text)
    return tamper


def _uncommit(b):
    os.remove(os.path.join(b, "MANIFEST.json.ok"))


def _marker_without_sha(b):
    okp = os.path.join(b, "MANIFEST.json.ok")
    marker = json.load(open(okp))
    del marker["file_sha256"]
    with open(okp, "w") as f:
        json.dump(marker, f)


TAMPER = {
    "program_bytes": _flip_prog,
    "torn_snapshot": _tear_snapshot,
    "marker_not_object": _marker("[]"),
    "marker_unparseable": _marker("{not json"),
    "uncommitted": _uncommit,
    "marker_without_sha": _marker_without_sha,
    "member_row_name_not_str": lambda b: _rewrite_manifest(
        b, lambda m: m["members"].append({"name": 5, "bytes": 1,
                                          "sha256": "x"})),
    "missing_field": lambda b: _rewrite_manifest(
        b, lambda m: m.pop("serve_dtype")),
    "empty_buckets": lambda b: _rewrite_manifest(
        b, lambda m: m.update(buckets=[])),
    "program_without_row": lambda b: _rewrite_manifest(
        b, lambda m: m["programs"].append({"name": "prog-0099.pkl",
                                           "key": "('x',)"})),
    "future_format": lambda b: _rewrite_manifest(
        b, lambda m: m.update(format_version=2)),
    "unparseable_key": lambda b: _rewrite_manifest(
        b, lambda m: m["programs"][0].update(key="not a key")),
    "index_without_row": lambda b: _rewrite_manifest(
        b, lambda m: m.update(index={
            "member": "index.embed.npz", "metric": "dot", "node": "",
            "rows": 1, "dim": 4, "k": 1, "buckets": [1]})),
}


@pytest.mark.parametrize("case", sorted(TAMPER))
def test_tampered_bundles_same_verdicts(ref, tmp_path, case):
    """Each tamper case gets the same report from both packages'
    ``verify_bundle``; where it fails, both ``load_bundle`` raise and
    both scans of the directory fall back to the snapshot."""
    d = tmp_path / "models"
    d.mkdir()
    shutil.copy(ref["snap"], str(d / "0001.model.npz"))
    b = str(d / "0001.model.bundle")
    shutil.copytree(ref["bundle"], b)
    TAMPER[case](b)
    rrep, prep = rb.verify_bundle(b), pb.verify_bundle(b)
    assert _report(prep) == _report(rrep)
    load_fails = []
    for mod in (rb, pb):
        try:
            mod.load_bundle(b)
            load_fails.append(False)
        except mod.BundleError:
            load_fails.append(True)
    assert load_fails[0] == load_fails[1]
    if case == "unparseable_key":
        # verified bytes, an unusable key: the load refuses it
        assert prep["ok"] and load_fails == [True, True]
        return
    assert not prep["ok"] and load_fails == [True, True]
    snap = os.path.join(str(d), "0001.model.npz")
    assert pswap.latest_verified(str(d)) == rswap.latest_verified(str(d)) \
        == (1, snap)


def test_fault_truncated_program_same_verdict(ref):
    """A torn write of a program member on the ``fault://`` store: both
    packages' schemes share one store and give the same verdict."""
    rfs = RefFaultFS("fault").install()
    pfs = FaultFS("fault").install()
    try:
        pfs.store = rfs.store
        uri = "fault://store/0001.model.bundle"
        for name in os.listdir(ref["bundle"]):
            with open(os.path.join(ref["bundle"], name), "rb") as f:
                rfs.store["%s/%s" % (uri, name)] = f.read()
        assert pb.verify_bundle(uri)["ok"] and rb.verify_bundle(uri)["ok"]
        victim = uri + "/prog-0000.pkl"
        data = rfs.store[victim]
        pfs.truncate_tail = 64
        with open_stream(victim, "wb") as f:
            f.write(data)
        pfs.clear_faults()
        prep, rrep = pb.verify_bundle(uri), rb.verify_bundle(uri)
        assert _report(prep) == _report(rrep)
        assert not prep["ok"] and "prog-0000" in prep["error"]
    finally:
        pfs.uninstall()
        rfs.uninstall()


# -- names and keys -------------------------------------------------------


@pytest.mark.parametrize("path", [
    "/m/0042.model.npz", "/m/0042.model.bundle", "/m/0042.model.bundle/",
    "/m/custom.npz", "/m/custom", "s3://b/m/0007.model.npz",
    "fault://store/0001.model.npz"])
def test_default_bundle_path_alike(path):
    assert pb.default_bundle_path(path) == rb.default_bundle_path(path)


@pytest.mark.parametrize("text", [
    repr(("pred",) + rreg.pred_sig((8, 24), np.dtype(np.float32), True,
                                   0, (5,))),
    repr(("update",) + rreg.update_sig((8, 24), "float32", (8, 1),
                                       False, 0, True)),
    repr(("kernel", "conv_epilogue", "0123456789abcdef")),
    "'not-a-key-tuple'", "()", "(1, 2)", "[('pred',)]"])
def test_parse_key_alike(text):
    outs = []
    for mod in (rreg, preg):
        try:
            outs.append(mod.parse_key(text))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]


def test_kernel_key_names_this_trees_library():
    key = preg.kernel_key("conv_epilogue")
    sha, so = kernels.library_key("conv_epilogue")
    assert key == ("kernel", "conv_epilogue", sha) and len(sha) == 16
    assert os.path.basename(so) == "conv_epilogue-%s.so" % sha
    assert preg.parse_key(repr(key)) == key == rreg.parse_key(repr(key))


# -- the kernel-library store ---------------------------------------------

LIB = b"\x7fELF synthetic conv_epilogue library"


@pytest.fixture
def libdir(tmp_path, monkeypatch):
    """A private BUILD_DIR holding a synthetic conv_epilogue library, a
    fresh build_info, and a port bundle that seals it."""
    build = tmp_path / "_build"
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    monkeypatch.setattr(kernels, "build_info", {})
    so = kernels.library_key("conv_epilogue")[1]
    os.makedirs(str(build))
    with open(so, "wb") as f:
        f.write(LIB)
    snap = str(tmp_path / "0001.model.npz")
    t = RefTrainer(CFG, mesh=make_mesh(1, 1))
    t.init_model()
    t.save_model(snap)
    bundle = str(tmp_path / "0001.model.bundle")
    _, stats = _port_export(snap, bundle, libraries=("conv_epilogue",))
    assert stats["programs"] == 1
    os.remove(so)                        # a fresh tree: nothing built
    return {"so": so, "bundle": bundle, "build": str(build)}


def _boot(bundle, cfg=PORT_CFG):
    sink = MemorySink()
    engine = build_engine(cfg, bundle, device="cpu", monitor=Monitor(sink))
    (art,) = [r for r in sink.records if r["event"] == "artifact_load"]
    warns = [r["code"] for r in sink.records if r["event"] == "warning"]
    return engine, art, warns


def test_library_store_installs_and_reexports(libdir):
    """A matching boot writes the sealed library to its path (a hit:
    build_kernels would find it and run no nvcc); an in-place re-export
    ships the same member bytes; the reference reads that bundle."""
    man = pb.bundle_manifest(libdir["bundle"])
    (prog,) = man["programs"]
    assert preg.parse_key(prog["key"]) == preg.kernel_key("conv_epilogue")
    engine, art, warns = _boot(libdir["bundle"])
    assert art["fingerprint_match"] and (art["hits"], art["rebuilds"]) \
        == (1, 0) and warns == []
    with open(libdir["so"], "rb") as f:
        assert f.read() == LIB
    assert kernels.build_info["conv_epilogue"]["log"] == "bundle"
    assert kernels.build_kernels(("conv_epilogue",)) == {
        "conv_epilogue": libdir["so"]}          # found: no nvcc
    before = open(os.path.join(libdir["bundle"], prog["name"]),
                  "rb").read()
    engine.trainer.programs.libraries.add("conv_epilogue")
    os.remove(libdir["so"])              # re-export reads the source
    stats = pb.export_bundle(engine, libdir["bundle"])
    assert stats["programs"] == 1
    man2 = pb.bundle_manifest(libdir["bundle"])
    assert man2["programs"] == man["programs"]
    assert open(os.path.join(libdir["bundle"], prog["name"]),
                "rb").read() == before == LIB
    assert rb.verify_bundle(libdir["bundle"])["ok"]
    (rkey, rblob), = rb.load_bundle(libdir["bundle"]).programs
    assert rkey == preg.kernel_key("conv_epilogue") and rblob == LIB


def test_library_store_rebuilds_a_stale_hash(libdir, monkeypatch):
    monkeypatch.setattr(kernels, "NVCC_FLAGS",
                        kernels.NVCC_FLAGS + ("-DSTALE",))
    _, art, warns = _boot(libdir["bundle"])
    assert art["fingerprint_match"] and (art["hits"], art["rebuilds"]) \
        == (0, 1)
    assert len(warns) == 1 and warns[0].startswith(
        "artifact_program_rebuilt")
    assert not os.listdir(libdir["build"])


def test_library_store_rebuilds_an_unwritable_library(libdir, monkeypatch,
                                                      tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_bytes(b"")
    monkeypatch.setattr(kernels, "BUILD_DIR", str(blocker / "_build"))
    _, art, warns = _boot(libdir["bundle"])
    assert (art["hits"], art["rebuilds"]) == (0, 1) and len(warns) == 1


def test_library_store_mismatch_installs_nothing(libdir):
    """Another weight residency than the sealed one is a mismatch: one
    warning, every program a rebuild, nothing written."""
    _, art, warns = _boot(libdir["bundle"],
                          PORT_CFG + [("serve_weight_residency", "0")])
    assert not art["fingerprint_match"]
    assert (art["hits"], art["rebuilds"]) == (0, 1)
    assert warns == ["artifact_fingerprint_mismatch"]
    assert not os.listdir(libdir["build"])


def test_bundle_sealing_an_index_is_not_served(ref, tmp_path):
    b = str(tmp_path / "0001.model.bundle")
    shutil.copytree(ref["bundle"], b)
    blob = b"corpus"
    with open(os.path.join(b, "index.embed.npz"), "wb") as f:
        f.write(blob)
    _rewrite_manifest(b, lambda m: (m["members"].append({
        "name": "index.embed.npz", "bytes": len(blob),
        "sha256": hashlib.sha256(blob).hexdigest()}), m.update(index={
            "member": "index.embed.npz", "metric": "dot", "node": "",
            "rows": 1, "dim": 4, "k": 1, "buckets": [1]})))
    assert pb.verify_bundle(b)["ok"] and rb.verify_bundle(b)["ok"]
    assert pb.read_index_member(b) == rb.read_index_member(b) == blob
    # the member's bytes are no index: the typed IndexError_ of both
    # packages, and the port builds no session around it
    with pytest.raises(PortIndexError) as e:
        ServeSession(PORT_CFG, model_path=b, device="cpu")
    with pytest.raises(RefIndexError) as r:
        RefIndex.deserialize(rb.read_index_member(b))
    assert str(e.value) == str(r.value)


# -- the watcher ----------------------------------------------------------


def _predict(port, rows):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/predict",
                     json.dumps({"rows": rows.reshape(
                         rows.shape[0], -1).tolist()}),
                     {"Content-Type": "application/json"})
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _models(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/v1/models")
        return json.loads(conn.getresponse().read())["models"]
    finally:
        conn.close()


def test_watcher_flips_snapshot_to_bundle_at_same_counter(ref, tmp_path):
    """A served snapshot's counter gains a bundle: a torn one warns once
    and is not served; its re-export flips the entry to the bundle, with
    the same rows before and after."""
    d = tmp_path / "models"
    d.mkdir()
    snap = str(d / "0001.model.npz")
    shutil.copy(ref["snap"], snap)
    sink = MemorySink()
    fleet = FleetServer(PORT_CFG + [
        ("serve_models", "default=%s" % d), ("serve_http_port", "0"),
        ("serve_binary_port", "-1"), ("serve_swap_poll_s", "30")],
        monitor=Monitor(sink), device="cpu")
    try:
        fleet.start()
        port = fleet.http_port
        (m,) = _models(port)
        assert (m["counter"], m["bundle"]) == (1, False)
        before = _predict(port, ref["rows"][:2])
        b = str(d / "0001.model.bundle")
        _port_export(snap, b)
        member = os.path.join(b, pb.SNAPSHOT_MEMBER)
        data = bytearray(open(member, "rb").read())
        data[len(data) // 2] ^= 0xFF     # a flipped byte: sha fails
        with open(member, "wb") as f:
            f.write(bytes(data))
        w = fleet._watchers[0]
        assert w.check_once() is None and w.check_once() is None
        codes = [r["code"] for r in sink.records
                 if r["event"] == "warning"]
        assert codes == ["bundle_upgrade_invalid:%s" % b]
        _port_export(snap, b)            # re-export: a new marker
        fleet.notify_watchers()
        deadline = time.monotonic() + 30
        while fleet.router.resolve("default").path != b:
            assert time.monotonic() < deadline, "no flip to the bundle"
            time.sleep(0.02)
        (m,) = _models(port)
        assert (m["counter"], m["bundle"], m["path"]) == (1, True, b)
        after = _predict(port, ref["rows"][:2])
        assert after["rows"] == before["rows"] == 2
        np.testing.assert_array_equal(np.asarray(after["result"]),
                                      np.asarray(before["result"]))
        swaps = [r for r in sink.records if r["event"] == "hot_swap"]
        assert [(r["old_counter"], r["new_counter"], r["path"])
                for r in swaps] == [(1, 1, b)]
    finally:
        fleet.close()
