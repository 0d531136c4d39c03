"""``task = build_index``, the sealed index and the served search
operations of the port against the reference, on the CPU.

One reference snapshot of a small MLP (64 -> 8 -> 4, softmax) over 80
seeded 8x8 digits (the reference's ``tests/test_retrieval.py`` setup)
is indexed by both CLIs (``index_metric = cosine``, ``index_rows =
48``, ``search_k = 4``, ``search_buckets = 1,4``):

- the manifests' ``index`` blocks are equal and each bundle verifies
  in both packages; the index ids are equal and the vectors within
  rtol 1e-5 / atol 1e-6 (float32 products of 64 and 8 terms summed in
  another order by oneDNN and XLA, then the softmax and the cosine
  normalization in each framework);
- the port serves the reference's bundle: its search answers the ids of
  the reference's ``RetrievalEngine`` over the same index (scores within
  rtol 1e-6 / atol 1e-6);
- a port ``FleetServer`` on the port's bundle answers ``/v1/embed``,
  ``/v1/search`` (``fan_out`` 0 and 1), ``#search:k`` and ``#fsearch:k``
  on CXN1, with the reference engine's ids over the sealed index, zero
  search compile events and the index block in ``/v1/models``; a model
  without an index answers a search with the reference's
  ``bad_request`` message, word for word;
- a second generation committed under concurrent fsearch traffic flips
  model and index as one pair: no failed request, every answer one
  generation's, never one generation's embedding against the other's
  corpus;
- ``task = continual`` with ``continual_index_rows = 16`` seals into
  each generation's bundle the first 16 training rows embedded by that
  generation's weights: within rtol 1e-5 / atol 1e-6 of the reference's
  ``extract`` of the same rows on the generation's snapshot.

The reference's own bundle boot fails in this container (ROADMAP queue
3), so its engine over the sealed index, its oracle and its snapshot
flows are the oracle here.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cxxnet_tpu.artifact import bundle as rb
from cxxnet_tpu.artifact.registry import ProgramRegistry
from cxxnet_tpu.io.data import DataBatch as RefBatch
from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.parallel import make_mesh
from cxxnet_tpu.retrieval import EmbeddingIndex as RefIndex
from cxxnet_tpu.retrieval import RetrievalEngine as RefEngine
from cxxnet_tpu.retrieval import oracle_topk as ref_oracle
from cxxnet_tpu.serve import FleetServer as RefFleet
from cxxnet_tpu.utils.config import parse_config
from cxxnet_tpu_torch.artifact import bundle as pb
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.monitor import MemorySink, Monitor
from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
from cxxnet_tpu_torch.retrieval import EmbeddingIndex
from cxxnet_tpu_torch.serve import BinaryClient, FleetServer, ServeSession
from cxxnet_tpu_torch.utils.config import parse_config as port_parse
from cxxnet_tpu_torch.utils.config import split_sections
from tests.test_trainer import synth_idx

VEC_RTOL, VEC_ATOL = 1e-5, 1e-6
SCORE_RTOL, SCORE_ATOL = 1e-6, 1e-6
K = 4

NET = """
netconfig=start
layer[+1:h] = fullc:fc1
  nhidden = 8
  init_sigma = 0.1
layer[+1] = relu
layer[h->o] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 16
eta = 0.1
"""
INDEX_ARGS = ["task=build_index", "index_metric=cosine", "index_rows=48",
              "search_k=%d" % K, "search_buckets=1,4"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _conf(d, n=80):
    pimg, plab = synth_idx(str(d), n=n, d=8, name="retr")
    text = """data = train
iter = mnist
  path_img = "%s"
  path_label = "%s"
  silent = 1
iter = end
%s
print_step = 0
""" % (pimg, plab, NET)
    p = str(d / "run.conf")
    with open(p, "w") as f:
        f.write(text)
    return p


def _snapshot(path, seed):
    t = RefTrainer(parse_config(NET) + [("seed", str(seed))],
                   mesh=make_mesh(1, 1))
    t.init_model()
    t.save_model(path)
    return path


def _port_build(conf, snap, out, extra=()):
    argv = [conf, "dev=cpu", "model_in=" + snap, "export_out=" + out] \
        + INDEX_ARGS + list(extra)
    assert LearnTask().run(argv) == 0
    return out


def _rows(n, seed):
    return np.random.RandomState(seed).rand(n, 64).astype(np.float32)


def _index(bundle):
    return EmbeddingIndex.deserialize(pb.read_index_member(bundle))


def _ref_engine(bundle):
    idx = RefIndex.deserialize(rb.read_index_member(bundle))
    eng = RefEngine(idx, ProgramRegistry(), k=K, buckets=(1, 4))
    eng.warmup(warm_run=False)
    return eng


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("build_index")
    (d / "models").mkdir()
    conf = _conf(d)
    snap = _snapshot(str(d / "0001.model.npz"), seed=0)
    ref_bundle = str(d / "ref.model.bundle")
    assert RefTask().run([conf, "model_in=" + snap,
                          "export_out=" + ref_bundle] + INDEX_ARGS) == 0
    port_bundle = _port_build(
        conf, snap, str(d / "models" / "0001.model.bundle"),
        ["monitor=jsonl", "monitor_path=" + str(d / "port.jsonl")])
    return {"dir": d, "conf": conf, "snap": snap, "ref": ref_bundle,
            "port": port_bundle}


def test_build_index_through_both_clis(built):
    pman = pb.bundle_manifest(built["port"])
    rman = rb.bundle_manifest(built["ref"])
    assert pman["index"] == rman["index"]
    assert pman["index"]["rows"] == 48 and pman["index"]["k"] == K
    assert pman["index"]["buckets"] == [1, 4]
    for b in (built["port"], built["ref"]):
        assert pb.verify_bundle(b)["ok"] and rb.verify_bundle(b)["ok"]
    pi, ri = _index(built["port"]), _index(built["ref"])
    np.testing.assert_array_equal(pi.ids, ri.ids)
    assert (pi.metric, pi.node) == (ri.metric, ri.node) == ("cosine", "")
    np.testing.assert_allclose(pi.vectors, ri.vectors, rtol=VEC_RTOL,
                               atol=VEC_ATOL)
    recs = read_jsonl(str(built["dir"] / "port.jsonl"))
    assert validate_records(recs, strict=False) == []
    kinds = [r["event"] for r in recs]
    for kind in ("run_start", "retrieval", "index_build", "export",
                 "task_end"):
        assert kind in kinds, kind
    (ret,) = [r for r in recs if r["event"] == "retrieval"]
    assert ret["recall"] == 1.0
    (ib,) = [r for r in recs if r["event"] == "index_build"]
    assert (ib["rows"], ib["dim"], ib["bytes"]) == (48, 4, 48 * 4 * 4)


def test_port_serves_the_reference_bundle(built):
    sess = ServeSession([("dev", "cpu")] + parse_config(NET),
                        model_path=built["ref"], device="cpu")
    try:
        r = sess.retrieval
        assert r is not None and r.k == K and r.buckets == (1, 4)
        assert r.counters_snapshot()["compile_events"] == 0
        assert sess.index_bytes == 48 * 4 * 4
        ref = _ref_engine(built["ref"])
        q = sess.predict(_rows(5, 3))
        for rows in (q[:1], q[:3], q):
            pid, psc = r.search(rows)
            rid, rsc = ref.search(rows)
            np.testing.assert_array_equal(pid, rid)
            np.testing.assert_allclose(psc, rsc, rtol=SCORE_RTOL,
                                       atol=SCORE_ATOL)
        assert r.counters_snapshot()["compile_events"] == 0
    finally:
        sess.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _fleet_cfg(models, extra=()):
    return parse_config(NET) + [
        ("dev", "cpu"), ("serve_models", models),
        ("serve_http_port", "0"), ("serve_binary_port", "0"),
        ("serve_swap_poll_s", "0.05"), ("serve_max_delay_ms", "1"),
        ("serve_queue_rows", "4096")] + list(extra)


@pytest.fixture(scope="module")
def fleet(built):
    sink = MemorySink()
    server = FleetServer(_fleet_cfg("main=%s;plain=%s" % (
        built["dir"] / "models", built["snap"])), monitor=Monitor(sink))
    server.start()
    yield server, sink
    server.close()


def test_fleet_embed_search_and_fsearch(built, fleet):
    server, sink = fleet
    ref = _ref_engine(built["port"])
    rows = _rows(3, 7)
    st, body = _post(server.http_port, "/v1/embed",
                     {"model": "main", "rows": rows.tolist()})
    assert st == 200 and np.shape(body["result"]) == (3, 4)
    q = np.asarray(body["result"], np.float32)
    rid, rsc = ref.search(q, k=3)
    st, sb = _post(server.http_port, "/v1/search",
                   {"model": "main", "rows": q.tolist(), "k": 3})
    assert st == 200 and sb["k"] == 3 and sb["rows"] == 3
    np.testing.assert_array_equal(np.asarray(sb["ids"]), rid)
    np.testing.assert_allclose(np.asarray(sb["scores"], np.float32), rsc,
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    oid, _ = ref_oracle(ref.index, q, 3)
    np.testing.assert_array_equal(np.asarray(sb["ids"]), oid)
    st, fb = _post(server.http_port, "/v1/search",
                   {"model": "main", "rows": rows.tolist(), "fan_out": 1,
                    "k": 3})
    assert st == 200 and fb["ids"] == sb["ids"]
    bc = BinaryClient("127.0.0.1", server.binary_port)
    try:
        status, out = bc.predict(q, model="main#search:3", tenant="t")
        assert status == "ok" and out.shape == (3, 6)
        np.testing.assert_array_equal(out[:, :3].astype(np.int64), rid)
        status, out2 = bc.predict(rows, model="main#fsearch:3",
                                  tenant="t")
        assert status == "ok"
        np.testing.assert_array_equal(out2[:, :3], out[:, :3])
        status, msg = bc.predict(q, model="main#search:9", tenant="t")
        assert status == "bad_request" and "search_k" in msg
    finally:
        bc.close()
    row = [m for m in server.health_snapshot()["model_health"]
           if m["model"] == "main"][0]
    assert row["compile_events"] == 0
    assert row["search_compile_events"] == 0
    assert row["search_aot_hits"] >= 3
    d = [m for m in server.describe() if m["model"] == "main"][0]
    assert d["index"]["rows"] == 48 and d["index"]["k"] == K
    assert d["index"]["buckets"] == [1, 4]
    assert d["device_mem_bytes"] >= 48 * 4 * 4
    assert "index" not in [m for m in server.describe()
                           if m["model"] == "plain"][0]
    errs = validate_records(sink.records)
    assert not errs, errs[:5]


def test_index_less_model_answers_as_the_reference(built, fleet):
    server, _ = fleet
    ref = RefFleet(parse_config(NET) + [
        ("serve_models", "plain=%s" % built["snap"]),
        ("serve_http_port", "0"), ("serve_binary_port", "-1")])
    ref.start()
    try:
        body = {"model": "plain", "rows": [[0.0] * 4]}
        got = _post(server.http_port, "/v1/search", body)
        want = _post(ref.http_port, "/v1/search", body)
        assert got == want
        assert got[0] == 400 and "serves no embedding index" in \
            got[1]["message"]
        body["fan_out"] = 1
        body["rows"] = _rows(1, 0).tolist()
        assert _post(server.http_port, "/v1/search", body) \
            == _post(ref.http_port, "/v1/search", body)
    finally:
        ref.close()


def test_hot_swap_flips_model_and_index_as_a_pair(built, fleet):
    """Runs last against the shared fleet: it flips "main" to a second
    generation."""
    server, sink = fleet
    probe = _rows(1, 11)

    def fsearch():
        return _post(server.http_port, "/v1/search",
                     {"model": "main", "rows": probe.tolist(),
                      "fan_out": 1, "k": 3})

    def key(body):
        return tuple(body["ids"][0]) + tuple(
            np.float32(s) for s in body["scores"][0])

    st, g1 = fsearch()
    assert st == 200
    d = built["dir"]
    side = str(d / "side.model.bundle")
    snap2 = _snapshot(str(d / "0002.model.npz"), seed=9)
    _port_build(built["conf"], snap2, side)
    stop = threading.Event()
    res = {"ok": 0, "fail": [], "answers": set()}
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            st, body = fsearch()
            with lock:
                if st == 200:
                    res["ok"] += 1
                    res["answers"].add(key(body))
                else:
                    res["fail"].append((st, body))

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    os.rename(side, str(d / "models" / "0002.model.bundle"))
    server.notify_watchers()
    t0 = time.monotonic()
    while time.monotonic() - t0 < 30 \
            and server.router.resolve("main").counter < 2:
        time.sleep(0.05)
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert server.router.resolve("main").counter == 2
    st, g2 = fsearch()
    assert st == 200 and key(g2) != key(g1)
    assert res["fail"] == [] and res["ok"] > 0
    assert res["answers"] <= {key(g1), key(g2)}
    # the new generation's answer: its embedding against its own index
    ref2 = _ref_engine(str(d / "models" / "0002.model.bundle"))
    st, emb = _post(server.http_port, "/v1/embed",
                    {"model": "main", "rows": probe.tolist()})
    rid, _ = ref2.search(np.asarray(emb["result"], np.float32), k=3)
    assert g2["ids"] == rid.tolist()
    row = [m for m in server.health_snapshot()["model_health"]
           if m["model"] == "main"][0]
    assert row["search_compile_events"] == 0 and row["generation"] == 1
    assert [r for r in sink.records if r.get("event") == "hot_swap"]


def test_continual_index_rows_seal_each_generation(tmp_path):
    d = tmp_path
    conf = _conf(d, n=64)
    init = _snapshot(str(d / "init.npz"), seed=0)
    rc = LearnTask().run([
        conf, "dev=cpu", "task=continual", "model_in=" + init,
        "model_dir=" + str(d / "port"), "continual_task=finetune",
        "continual_gate=off", "continual_export_every=4",
        "continual_generations=2", "continual_index_rows=16",
        "index_metric=dot", "dispatch_period=2", "serve_buckets=1,16",
        "serve_http_port=0", "serve_binary_port=-1", "search_k=3",
        "search_buckets=1,4", "continual_linger_s=0"])
    assert rc == 0
    bundles = sorted(n for n in os.listdir(str(d / "port"))
                     if n.endswith(".model.bundle"))
    assert len(bundles) == 2
    # the first 16 rows of the training stream, as both packages read it
    with open(conf) as f:
        blocks, _ = split_sections(port_parse(f.read()))
    itr = create_iterator(blocks[0]["cfg"], [("batch_size", "16"),
                                             ("input_shape", "1,1,64")])
    itr.init()
    rows = np.array(next(iter(itr)).data, np.float32)
    itr.close()
    vecs = []
    for name in bundles:
        b = str(d / "port" / name)
        man = pb.bundle_manifest(b)
        assert man["index"]["rows"] == 16 and man["index"]["k"] == 3
        assert man["index"]["buckets"] == [1, 4]
        idx = _index(b)
        t = RefTrainer(parse_config(NET), mesh=make_mesh(1, 1))
        t.load_model(os.path.join(b, pb.SNAPSHOT_MEMBER))
        want = t.extract_feature(
            RefBatch(data=rows, label=np.zeros((16, 1), np.float32)),
            "top")
        np.testing.assert_allclose(idx.vectors, want.reshape(16, -1),
                                   rtol=VEC_RTOL, atol=VEC_ATOL)
        vecs.append(idx.vectors)
    assert not np.array_equal(vecs[0], vecs[1])
