"""The port's Python API (``cxxnet_tpu_torch.wrapper``) against the
reference's (``cxxnet_tpu.wrapper``): the cases of
``tests/test_wrapper.py``, through both packages from one reference
snapshot where a value is compared.

Tolerances: the iterators' arrays, a snapshot's ``get_weight`` and
``predict`` classes are identical; after updates (and for ``extract``)
rtol 1e-4 / atol 1e-6, as the CLI parity holds a round: the reference
averages gradients over its virtual CPU devices, the port over one
batch, so float32 sums differ in order.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu.wrapper import DataIter as RefIter
from cxxnet_tpu.wrapper import Net as RefNet
from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
from cxxnet_tpu_torch.wrapper import DataIter, Net, train

NET_CFG = """
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig = end
input_shape = 1,1,10
batch_size = 8
eta = 0.2
metric = error
"""
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _csv_file(tmp_path, n=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 10).astype(np.float32)
    y = (X @ rng.randn(10, 4)).argmax(1)
    p = tmp_path / "d.csv"
    with open(p, "w") as f:
        for i in range(n):
            f.write(",".join([str(y[i])] +
                             ["%.6f" % v for v in X[i]]) + "\n")
    return str(p)


def _iter_cfg(path):
    return """
iter = csv
  filename = %s
  input_shape = 1,1,10
  label_width = 1
iter = end
batch_size = 8
""" % path


def _xy(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(8, 1, 1, 10).astype(np.float32),        # NCHW
            rng.randint(0, 4, (8,)).astype(np.float32))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A reference net's initial snapshot: both packages load it."""
    path = str(tmp_path_factory.mktemp("wrap") / "ref0.npz")
    net = RefNet(dev="cpu", cfg=NET_CFG)
    net.init_model()
    net.save_model(path)
    return path


def both(snapshot):
    nets = []
    for cls in (RefNet, Net):
        net = cls(dev="cpu", cfg=NET_CFG)
        net.load_model(snapshot)
        nets.append(net)
    return nets


def test_dataiter_matches_the_reference(tmp_path):
    path = _csv_file(tmp_path)
    it, ref = DataIter(_iter_cfg(path)), RefIter(_iter_cfg(path))
    assert it.head and not it.tail
    with pytest.raises(RuntimeError):
        it.get_data()
    n = 0
    while it.next():
        assert ref.next()
        d = it.get_data()
        assert d.shape == (8, 1, 1, 10)          # NCHW at the API edge
        assert np.array_equal(d, ref.get_data())
        assert np.array_equal(it.get_label(), ref.get_label())
        assert it.get_label().shape == (8, 1)
        n += 1
    assert n == 8 and it.tail and not ref.next()
    it.before_first()
    assert it.head
    it.close()


def test_update_ndarray_and_predict_match_the_reference(snapshot):
    X, y = _xy()
    ref, net = both(snapshot)
    assert np.array_equal(net.predict(X), ref.predict(X))
    with pytest.raises(ValueError):
        net.update(X)                                 # no label
    for n in (ref, net):
        n.set_param("eta", "0.1")
        for r in range(3):
            n.start_round(r)
            n.update(X, y)
    pred = net.predict(X)
    assert pred.shape == (8,)
    assert set(np.unique(pred)).issubset({0., 1., 2., 3.})
    assert np.array_equal(pred, ref.predict(X))
    for layer in ("fc1", "fc2"):
        for tag in ("wmat", "bias"):
            np.testing.assert_allclose(net.get_weight(layer, tag),
                                       ref.get_weight(layer, tag),
                                       rtol=RTOL, atol=ATOL)


def test_predict_buckets_match_the_reference(snapshot):
    """A partial batch pads to its bucket and is cut back: the rows are
    those of the full batch."""
    X, _ = _xy()
    ref, net = both(snapshot)
    full = net.extract(X, "top")
    for n in (3, 5, 8):
        assert np.array_equal(net.predict(X[:n]), ref.predict(X[:n]))
        np.testing.assert_allclose(net.extract(X[:n], "top"), full[:n],
                                   rtol=RTOL, atol=ATOL)


def test_update_dataiter_and_evaluate(tmp_path, snapshot):
    """``train`` over a DataIter learns (the reference's case; the
    port draws its own initialization); ``evaluate`` from one snapshot
    gives the reference's metric line."""
    path = _csv_file(tmp_path)
    it, ev = DataIter(_iter_cfg(path)), DataIter(_iter_cfg(path))
    net = train(NET_CFG, it, 3, {"eta": "0.3"}, eval_data=ev, dev="cpu")
    s = net.evaluate(ev, "eval")
    assert "eval-error:" in s and float(s.split(":")[-1]) < 0.5
    ref, port = both(snapshot)
    assert port.evaluate(ev, "eval") == ref.evaluate(RefIter(
        _iter_cfg(path)), "eval")
    with pytest.raises(TypeError):
        port.evaluate(_xy()[0], "eval")
    it.close()
    ev.close()


def test_extract_and_weights_match_the_reference(snapshot):
    X, _ = _xy()
    ref, net = both(snapshot)
    feat = net.extract(X, "top[-1]")
    assert feat.shape == (8, 1, 1, 16)
    np.testing.assert_allclose(feat, ref.extract(X, "top[-1]"),
                               rtol=RTOL, atol=ATOL)
    w = net.get_weight("fc1", "wmat")
    assert w.shape == (16, 10)                       # reference (out,in)
    assert np.array_equal(w, ref.get_weight("fc1", "wmat"))
    w2 = np.arange(w.size, dtype=np.float32).reshape(w.shape) / w.size
    net.set_weight(w2, "fc1", "wmat")
    ref.set_weight(w2.ravel(), "fc1", "wmat")        # flat C-ABI input
    assert np.array_equal(net.get_weight("fc1", "wmat"), w2)
    np.testing.assert_allclose(net.extract(X, "top"),
                               ref.extract(X, "top"), rtol=RTOL, atol=ATOL)
    assert net.get_weight("nosuch", "wmat") is None
    with pytest.raises(ValueError):
        net.get_weight("fc1", "gamma")
    with pytest.raises(ValueError):
        net.set_weight(np.ones(3, np.float32), "fc1", "wmat")


def test_save_load_crosses_both_ways(tmp_path, snapshot):
    X, y = _xy()
    net = Net(dev="cpu", cfg=NET_CFG)
    net.load_model(snapshot)
    net.update(X, y)
    p1 = net.predict(X)
    path = str(tmp_path / "m.npz")
    net.save_model(path)
    for cls in (Net, RefNet):
        other = cls(dev="cpu", cfg=NET_CFG)
        other.load_model(path)
        assert np.array_equal(other.predict(X), p1)
        assert np.array_equal(other.get_weight("fc2", "wmat"),
                              net.get_weight("fc2", "wmat"))


def test_net_requires_init():
    net = Net(dev="cpu", cfg=NET_CFG)
    with pytest.raises(RuntimeError):
        net.predict(np.zeros((8, 1, 1, 10), np.float32))
    with pytest.raises(RuntimeError):
        net.counters()


def test_net_counters_snapshot(snapshot):
    X, y = _xy()
    ref, net = both(snapshot)
    for n in (ref, net):
        assert n.counters() == {"steps": 0, "examples": 0,
                                "last_round_examples_per_sec": 0.0}
        n.start_round(0)
        for _ in range(3):
            n.update(X, y)
    c = net.counters()
    assert (c["steps"], c["examples"]) == (3, 24)
    assert c["last_round_examples_per_sec"] == 0.0   # round still open
    net.start_round(1)                               # closes round 0
    assert net.counters()["last_round_examples_per_sec"] > 0
    rc = ref.counters()
    assert (rc["steps"], rc["examples"]) == (3, 24)


def test_net_multilabel_through_wrapper(tmp_path):
    rng = np.random.RandomState(2)
    X = rng.rand(16, 10).astype(np.float32)
    Y = rng.randint(0, 2, (16, 3)).astype(np.float32)
    p = tmp_path / "ml.csv"
    with open(p, "w") as f:
        for i in range(16):
            f.write(",".join(["%g" % v for v in Y[i]] +
                             ["%.6f" % v for v in X[i]]) + "\n")
    cfg = """
label_vec[0,3) = tags
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 8
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 3
layer[3->3] = multi_logistic
  target = tags
netconfig = end
input_shape = 1,1,10
label_width = 3
batch_size = 8
eta = 0.1
metric[tags] = rmse
"""
    it = DataIter("""
iter = csv
  filename = %s
  input_shape = 1,1,10
  label_width = 3
iter = end
batch_size = 8
""" % p)
    assert it.next()
    assert np.array_equal(it.get_label(), Y[:8])
    net = Net(dev="cpu", cfg=cfg)
    net.init_model()
    for r in range(2):
        net.start_round(r)
        it.before_first()
        while it.next():
            net.update(it)
    net.update(X[:8].reshape(8, 1, 1, 10), Y[:8])
    assert "ev-rmse[tags]:" in net.evaluate(it, "ev")
    it.close()


def test_bad_netconfig_raises_at_creation():
    with pytest.raises(ValueError, match="unknown layer type"):
        Net(dev="cpu", cfg=NET_CFG.replace("relu", "no_such_layer"))


@pytest.mark.parametrize("dev", ["tpu", "gpu", "gpu:0", "cuda"])
def test_accelerator_dev_without_gpu_raises(dev):
    """Every device name but ``cpu`` asks for the GPU, and without one
    the net raises: it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Net(dev=dev, cfg=NET_CFG)


def test_monitor_keys_through_the_wrapper(tmp_path, snapshot):
    """``monitor`` keys (in cfg or through ``set_param``) attach a
    monitor: the stream validates, a ``step`` per update; ``close``
    drains it and ends the trace window."""
    X, y = _xy()
    mpath = str(tmp_path / "w.jsonl")
    net = Net(dev="cpu", cfg=NET_CFG + "monitor = jsonl\n")
    net.set_param("monitor_path", mpath)
    net.set_param("monitor_trace_dir", str(tmp_path / "trace"))
    net.load_model(snapshot)
    for r in range(3):
        net.start_round(r)
        net.update(X, y)
    net.close()
    recs = read_jsonl(mpath)
    assert validate_records(recs) == []
    k = [r["event"] for r in recs]
    assert k[:3] == ["run_start", "model_info", "layout"]
    assert [r["step"] for r in recs if r["event"] == "step"] == [1, 2, 3]
    assert ("trace_start", 1) in [(r["event"], r.get("round"))
                                  for r in recs]
    assert os.listdir(str(tmp_path / "trace")) == ["trace_r1-1.json"]
