"""``channel_pad`` and ``input_layout`` in the port against the reference.

The planner (``cxxnet_tpu_torch/nnet/layout.py``) gives the reference's
``node_layouts``, ``_depad_layers`` and ``layout_summary`` for the same
graph: the reference's ``CHAIN_CONF`` and ``CONCAT_CONF``
(``tests/test_layout_fusion.py``) and Inception-BN-tiny, at Q = 4, 8,
12 and 128 (the tiny net's widths are multiples of 8: it pads at 12).

Training under ``channel_pad`` keeps every padded channel exactly zero
in the forward pass and gives it exactly-zero cotangents. It is not
bit-identical to the unpadded run on the CPU, as the reference's is on
XLA:CPU: PyTorch sums a per-channel reduction of an NHWC tensor (the
batch-norm moments, the bias and scale gradients) in an order that
depends on the channel count, so the padded width reorders those sums.
Two steps lie within rtol 1e-5 / atol 2e-6 of the unpadded run
(``PAD_RTOL``, ``PAD_ATOL``); ROADMAP.md queue 3 records it. Against the reference's
own padded training (on one device) the parameters lie within
``REF_RTOL`` / ``REF_ATOL``.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu import parallel as ref_parallel
from cxxnet_tpu.graph import NetGraph as RefGraph
from cxxnet_tpu.io.data import DataBatch as RefBatch
from cxxnet_tpu.nnet.net import FuncNet as RefNet
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.utils.config import parse_config as ref_parse_config
from cxxnet_tpu_torch import monitor
from cxxnet_tpu_torch.graph import NetGraph
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.models import inception_bn_tiny
from cxxnet_tpu_torch.nnet.layout import is_padded
from cxxnet_tpu_torch.nnet.net import FuncNet
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config
from test_layout_fusion import CHAIN_CONF, CONCAT_CONF

PAD_RTOL, PAD_ATOL = 1e-5, 2e-6
REF_RTOL, REF_ATOL = 1e-4, 1e-5
TINY_CONF = inception_bn_tiny(nclass=4, batch_size=4, image_size=16)
CONFS = {"chain": CHAIN_CONF, "concat": CONCAT_CONF, "tiny": TINY_CONF}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pairs(name, q):
    return list(parse_config(CONFS[name])) + [("channel_pad", str(q))]


def _nets(name, q):
    cfg = _pairs(name, q)
    g, rg = NetGraph(), RefGraph()
    g.configure(cfg)
    rg.configure(ref_parse_config(CONFS[name]) + [("channel_pad", str(q))])
    return FuncNet(g, g.batch_size), RefNet(rg, rg.batch_size)


QS = [4, 8, 12, 128]
PADS = {("chain", 4), ("chain", 8), ("concat", 4), ("concat", 8),
        ("tiny", 12)}


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("name", sorted(CONFS))
def test_plan_matches_reference(name, q):
    net, ref = _nets(name, q)
    assert net.node_layouts == ref.node_layouts
    assert net._depad_layers == ref._depad_layers
    assert net.layout_summary == ref.layout_summary
    assert bool(net.layout_summary["layers_padded"]) == ((name, q) in PADS)


def _data(seed=0, n=8, size=10, ch=3, nclass=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, ch).astype(np.float32),
            rng.randint(0, nclass, (n, 1)).astype(np.float32))


def _batch(name):
    if name == "tiny":
        return _data(n=4, size=16)
    return _data()


def _train(name, extra, steps=2, path=None):
    data, label = _batch(name)
    t = NetTrainer(parse_config(CONFS[name]) + list(extra), device="cpu")
    if path:
        t.load_model(path)
    else:
        t.init_model()
    for _ in range(steps):
        t.update(DataBatch(data=data, label=label))
    return t


def _max_diff(a, b):
    return max(float((a.params[k][t] - b.params[k][t]).abs().max())
               for k in a.params for t in a.params[k])


def _assert_close(a, b, rtol, atol):
    for k in a.params:
        for t in a.params[k]:
            np.testing.assert_allclose(
                np.asarray(a.params[k][t]), np.asarray(b.params[k][t]),
                rtol=rtol, atol=atol, err_msg="%s:%s" % (k, t))


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("name", sorted(CONFS))
def test_padded_training_holds_to_unpadded(name, q):
    """Logical parameters after two steps, padded against unpadded, and
    the running statistics stay logical."""
    base = _train(name, [])
    padded = _train(name, [("channel_pad", str(q))])
    _assert_close(padded, base, PAD_RTOL, PAD_ATOL)
    for lk, st in base.net_state.items():
        for k, v in st.items():
            assert padded.net_state[lk][k].shape == v.shape
            np.testing.assert_allclose(padded.net_state[lk][k], v,
                                       rtol=PAD_RTOL, atol=PAD_ATOL)
    if not padded.net.layout_summary["layers_padded"]:
        assert _max_diff(padded, base) == 0.0   # nothing padded: same run


@pytest.mark.parametrize("name", ["concat", "tiny"])
def test_padded_channels_are_zero_forward_and_backward(name):
    """Every padded channel of every node holds exactly 0 in the
    training forward, and the loss's cotangent there is exactly 0."""
    q = {"concat": "4", "tiny": "12"}[name]
    t = NetTrainer(parse_config(CONFS[name]) + [("channel_pad", q)],
                   device="cpu")
    t.init_model()
    data, label = _batch(name)
    net = t.net
    padded = [ni for ni, lay in enumerate(net.node_layouts)
              if is_padded(lay)]
    assert padded
    params = {lk: {k: v.detach().requires_grad_(True)
                   for k, v in sub.items()} for lk, sub in t.params.items()}
    with torch.enable_grad():
        nodes, _, logits = net.forward(params, t.net_state,
                                       torch.from_numpy(data), True,
                                       collect_logits=True)
        for ni in padded:
            nodes[ni].retain_grad()
        loss = sum(net.layer_objs[li].loss_value(v, torch.from_numpy(label),
                                                 None)
                   for li, v in logits.items())
        loss.backward()
    for ni in padded:
        off = 0
        for valid, pad in net.node_layouts[ni]:
            gap = slice(off + valid, off + valid + pad)
            assert torch.count_nonzero(nodes[ni][..., gap]) == 0
            g = nodes[ni].grad
            assert g is None or torch.count_nonzero(g[..., gap]) == 0
            off += valid + pad


@pytest.mark.parametrize("name", ["chain", "concat"])
def test_padded_training_against_reference(name, tmp_path, monkeypatch):
    """The reference's padded training (one device) and the port's from
    one reference snapshot: two steps, every parameter within
    REF_RTOL / REF_ATOL, and the same layout summary."""
    monkeypatch.setattr(ref_parallel, "default_data_axis",
                        lambda *a, **k: 1)
    extra = [("channel_pad", "4")]
    ref = RefTrainer(ref_parse_config(CONFS[name]) + extra)
    ref.init_model()
    path = str(tmp_path / "s0.model.npz")
    ref.save_model(path)
    data, label = _batch(name)
    for _ in range(2):
        ref.update(RefBatch(data=data, label=label))
    port = _train(name, extra, path=path)
    assert port.net.layout_summary == ref.net.layout_summary
    for lk, sub in port.params.items():
        for tag, v in sub.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(ref.params[lk][tag]),
                rtol=REF_RTOL, atol=REF_ATOL, err_msg="%s:%s" % (lk, tag))


def test_channel_pad_turns_pool_concat_off_and_serves_unpadded(tmp_path):
    """pool_concat_pallas is off under channel_pad (the alignment pass
    owns the concat), the frozen serve tree and the quantizer skip the
    padded layers, and eval rows equal the unpadded run's."""
    from cxxnet_tpu_torch.nnet.quantize import quantizable
    extra = [("pool_concat_pallas", "1")]
    plain = NetTrainer(parse_config(CONCAT_CONF) + extra, device="cpu")
    plain.init_model()
    assert plain.net.fused_concats
    path = str(tmp_path / "s.model.npz")
    plain.save_model(path)
    padded = NetTrainer(parse_config(CONCAT_CONF) + extra
                        + [("channel_pad", "4"), ("bn_fold_eval", "1")],
                        device="cpu")
    padded.load_model(path)
    assert not padded.net.fused_concats
    annotated = {li for li, layer in enumerate(padded.net.layer_objs)
                 if getattr(layer, "_out_pad", 0)
                 or getattr(layer, "_in_layout", None) is not None}
    assert annotated
    assert not annotated & {t.li for t in quantizable(padded.net)}
    tree = padded.freeze_serve_weights()
    g = padded.graph
    for li in annotated:
        assert "_oihw" not in tree[g.layer_key(li)]
    data, _ = _batch("concat")
    top = g.num_nodes - 1
    a = plain.pred(torch.from_numpy(data), (top,))[0]
    b = padded.pred(torch.from_numpy(data), (top,))[0]
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_input_layout_rowmajor_gives_identical_outputs(capsys):
    """input_layout = rowmajor pins a TPU layout: the port warns once
    (the reference's code) and trains bit for bit as without it."""
    base = _train("chain", [])
    monitor.reset_warnings()
    capsys.readouterr()
    pinned = _train("chain", [("input_layout", "rowmajor")])
    assert _max_diff(base, pinned) == 0.0
    assert capsys.readouterr().err.count(
        "warning input_layout_unsupported:") == 1
    data, _ = _batch("chain")
    top = base.graph.num_nodes - 1
    assert torch.equal(base.pred(torch.from_numpy(data), (top,))[0],
                       pinned.pred(torch.from_numpy(data), (top,))[0])
    with pytest.raises(ValueError, match="input_layout"):
        _train("chain", [("input_layout", "colmajor")], steps=0)
