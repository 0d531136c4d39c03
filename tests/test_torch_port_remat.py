"""Rematerialization in the port (``cxxnet_tpu_torch/nnet/remat.py``)
against its own ``remat = none`` run and the reference's remat run.

On the CPU a recompute gives the same bits as the forward, so every
policy trains to ``none``'s parameters bit for bit; against the
reference's run under the same policy the tolerance is the reference's
own remat test's (``tests/test_trainer.py:619-642``). What each policy
keeps for the backward is read with ``saved_tensors_hooks``: the
checkpoint saves each segment's inputs through autograd, outside its
own hooks."""

import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import parse_config as jax_parse
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.layers.conv import ConvolutionLayer
from cxxnet_tpu_torch.models import inception_bn_tiny
from cxxnet_tpu_torch.nnet import remat
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config

# tests/test_trainer.py's BN_CONV_CONF and _bn_batch
BN_CONV_CONF = """
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 8
  random_type = xavier
layer[1->2] = batch_norm:bn1
layer[2->3] = relu
layer[3->4] = flatten
layer[4->5] = fullc:fc1
  nhidden = 4
  init_sigma = 0.05
layer[5->5] = softmax
netconfig=end
input_shape = 1,8,8
batch_size = 40
eta = 0.05
momentum = 0.9
metric[label] = error
"""

# a conv net with dropout, and one whose segments read each other's
# kept values both ways (a split's branch meets the convs after it in a
# concat), so the cut's cycle merge runs
DROPOUT_CONF = BN_CONV_CONF.replace(
    "layer[2->3] = relu\n",
    "layer[2->3] = relu\nlayer[3->3] = dropout\n  threshold = 0.5\n")
CYCLE_CONF = """
netconfig=start
layer[0->1] = conv:c0
  kernel_size = 3
  pad = 1
  nchannel = 4
layer[1->2,3] = split
layer[2->4] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 4
layer[4->5] = conv:c2
  kernel_size = 3
  pad = 1
  nchannel = 4
layer[3,5->6] = ch_concat
layer[6->7] = batch_norm:bn
layer[7->8] = relu
layer[8->9] = flatten
layer[9->10] = fullc:fc
  nhidden = 4
layer[10->10] = softmax
netconfig=end
input_shape = 1,8,8
batch_size = 40
eta = 0.05
momentum = 0.9
"""

POLICIES = ("full", "dots", "conv")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops on one thread: at these sizes more threads
    only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bn_batch(rng, n=40):
    data = rng.rand(n, 8, 8, 1).astype(np.float32)
    label = rng.randint(0, 4, (n, 1)).astype(np.float32)
    return data, label


def _train(t, data, label, batch_cls):
    """test_trainer's schedule: 2 updates, then 3 run_steps (the
    reference's on a batch put on its device)."""
    for _ in range(2):
        t.update(batch_cls(data=data, label=label))
    if batch_cls is JaxBatch:
        data, label = t._put_batch_array(data), t._put_batch_array(label)
    t.run_steps(batch_cls(data=data, label=label), 3)


def _port(conf, extra=(), snap=None):
    t = NetTrainer(parse_config(conf) + list(extra), device="cpu")
    if snap is None:
        t.init_model()
    else:
        t.load_model(snap)
    return t


def _params(t):
    return {(lk, tg): v.detach().clone() for lk, sub in t.params.items()
            for tg, v in sub.items()}


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    """One JAX snapshot of BN_CONV_CONF; the port's none run from it."""
    d = tmp_path_factory.mktemp("remat")
    j = JaxTrainer(jax_parse(BN_CONV_CONF))
    j.init_model()
    snap = str(d / "s0.model.npz")
    j.save_model(snap)
    data, label = _bn_batch(np.random.RandomState(5))
    t = _port(BN_CONV_CONF, snap=snap)
    _train(t, data, label, DataBatch)
    return {"snap": snap, "data": data, "label": label,
            "none": _params(t), "none_loss": t.last_loss}


@pytest.mark.parametrize("mode", POLICIES)
def test_remat_policies_match_none_and_the_reference(bn_runs, mode):
    """Each policy: the port's parameters are its none run's bits; the
    reference's run under the same policy from the same snapshot lies
    within its own remat test's tolerance of them."""
    t = _port(BN_CONV_CONF, [("remat", mode)], bn_runs["snap"])
    _train(t, bn_runs["data"], bn_runs["label"], DataBatch)
    _assert_same_bits(_params(t), bn_runs["none"])
    assert t.last_loss == bn_runs["none_loss"]
    j = JaxTrainer(jax_parse(BN_CONV_CONF) + [("remat", mode)])
    j.load_model(bn_runs["snap"])
    _train(j, bn_runs["data"], bn_runs["label"], JaxBatch)
    for lk, tg in sorted(bn_runs["none"]):
        np.testing.assert_allclose(
            t.params[lk][tg].numpy(), np.asarray(j.params[lk][tg]),
            rtol=2e-5, atol=1e-7, err_msg="%s/%s" % (lk, tg))
    np.testing.assert_allclose(t.last_loss, j.last_loss, rtol=1e-5)


@pytest.mark.parametrize("mode", POLICIES)
@pytest.mark.parametrize("conf", [DROPOUT_CONF, CYCLE_CONF],
                         ids=["dropout", "cycle"])
def test_remat_redraws_masks_and_runs_merged_segments(conf, mode):
    """A recompute redraws the dropout mask the forward drew (its
    generator is seeded by the step, not the global one); segments that
    read each other's kept values merge. Both give none's bits."""
    data, label = _bn_batch(np.random.RandomState(7))
    runs = {}
    for m in ("none", mode):
        t = _port(conf, [("remat", m), ("seed", "3")])
        _train(t, data, label, DataBatch)
        runs[m] = _params(t)
    _assert_same_bits(runs[mode], runs["none"])


def test_cycle_conf_merges_its_segments():
    """CYCLE_CONF's split, c1 and concat share a group through values
    that are not kept; c2 reads c1's kept output and the concat reads
    c2's, so under conv the two groups merge into one."""
    t = _port(CYCLE_CONF)
    segs = remat.plan(t.net, "conv")
    assert [s.layers for s in segs] == [(0,), (1, 2, 3, 4, 5, 6, 7, 8, 9)]
    assert segs[1].inputs == ((1, 0),)
    assert segs[1].losses == (9,)


def test_remat_barrier_zero_runs_the_none_path(bn_runs):
    """remat_barrier = 0: the reference's XLA CSEs the recompute away;
    the port runs none's path (the same bits, and everything saved)."""
    def shapes(t):
        return sorted((tuple(v.shape), str(v.dtype)) for v in _saved(
            t, bn_runs["data"], bn_runs["label"]).values())

    t = _port(BN_CONV_CONF, [("remat", "conv"), ("remat_barrier", "0")],
              bn_runs["snap"])
    assert shapes(t) == shapes(_port(BN_CONV_CONF, snap=bn_runs["snap"]))
    assert len(shapes(t)) > 2
    t = _port(BN_CONV_CONF, [("remat", "full"), ("remat_barrier", "0")],
              bn_runs["snap"])
    _train(t, bn_runs["data"], bn_runs["label"], DataBatch)
    _assert_same_bits(_params(t), bn_runs["none"])


def test_remat_rejects_unknown_policy():
    for make in (lambda: _port(BN_CONV_CONF, [("remat", "segments")]),
                 lambda: JaxTrainer(jax_parse(BN_CONV_CONF)
                                    + [("remat", "segments")])
                 .init_model()):
        with pytest.raises(ValueError, match="remat must be"):
            make()


def _saved(t, data, label, conv_outs=None):
    """{id: tensor} of what one update's forward saves for the backward
    (through autograd, outside any checkpoint's own hooks); with
    ``conv_outs`` a list, the conv layers' outputs of the forward go
    there."""
    packed = {}
    orig = ConvolutionLayer.forward

    def forward(self, *a, **k):
        outs, s = orig(self, *a, **k)
        if conv_outs is not None and torch.is_grad_enabled():
            conv_outs.append(outs[0])
        return outs, s

    def pack(x):
        packed[id(x)] = x
        return x

    ConvolutionLayer.forward = forward
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            t.update(DataBatch(data=data, label=label))
    finally:
        ConvolutionLayer.forward = orig
    return packed


def test_saved_bytes_rank_full_conv_none():
    """Inception-BN-tiny (bn_apply's Function, the pallas_fullc
    product): full keeps the batch alone, conv the batch and conv
    outputs only (each of them a tensor some conv layer returned),
    none every residual; the bytes rank full < conv < none."""
    cfg = parse_config(inception_bn_tiny(nclass=8, batch_size=4,
                                         image_size=16)
                       .replace("fullc:fc1", "pallas_fullc:fc1")) \
        + [("bn_pallas", "1"), ("bn_fuse_relu", "1")]
    rng = np.random.RandomState(2)
    data = rng.rand(4, 16, 16, 3).astype(np.float32)
    label = rng.randint(0, 8, (4, 1)).astype(np.float32)
    nbytes, saved, convs = {}, {}, {}
    for mode in ("none", "full", "conv"):
        t = NetTrainer(cfg + [("remat", mode)], device="cpu")
        t.init_model()
        convs[mode] = []
        saved[mode] = _saved(t, data, label, convs[mode])
        nbytes[mode] = sum(v.numel() * v.element_size()
                           for v in saved[mode].values())
    assert 0 < nbytes["full"] < nbytes["conv"] < nbytes["none"]
    assert [tuple(v.shape) for v in saved["full"].values()] \
        == [data.shape]
    conv_ids = {id(c) for c in convs["conv"]}
    others = [v for k, v in saved["conv"].items() if k not in conv_ids]
    assert [tuple(v.shape) for v in others] == [data.shape]
    assert len(saved["conv"]) > 1


def test_chip_smoke_remat_launches_on_the_cpu():
    """chip_smoke.REMAT_LAUNCHES, the launches a step it asserts on the
    card, counted here as calls of the kernels' wrappers (each launches
    once on the card) on its bench-set Inception-BN-224 at batch 1 (the
    counts do not depend on the batch); ``full_one_cut`` under
    ``chip_smoke.remat_one_cut``."""
    import contextlib
    import chip_smoke
    names = {"bn_apply_fwd": "bn_apply_fwd_bf16",
             "bn_apply_bwd": "bn_apply_bwd_bf16",
             "matmul_kernel": "matmul_bf16"}
    orig = {n: getattr(kernels, n) for n in names}
    rng = np.random.RandomState(1)
    batch = DataBatch(rng.rand(1, 224, 224, 3).astype(np.float32),
                      rng.randint(0, 1000, (1, 1)).astype(np.float32))
    keys = {"none": [], "full": [("remat", "full")],
            "dots": [("remat", "dots")], "conv": [("remat", "conv")],
            "full_one_cut": [("remat", "full")]}
    assert set(keys) == set(chip_smoke.REMAT_LAUNCHES)
    for pol, extra in keys.items():
        calls = {v: 0 for v in names.values()}

        def counted(n):
            def f(*a, **k):
                calls[names[n]] += 1
                return orig[n](*a, **k)
            return f

        with chip_smoke.remat_one_cut("full") if pol == "full_one_cut" \
                else contextlib.nullcontext():
            t = NetTrainer(chip_smoke.train_cfg_bf16(1) + extra
                           + [("eval_train", "0")], device="cpu")
            t.init_model()
            try:
                for n in names:
                    setattr(kernels, n, counted(n))
                t.update(batch)
            finally:
                for n, f in orig.items():
                    setattr(kernels, n, f)
        assert remat._LEVELS["full"] == ((), ("conv_out",))
        expected = {k: v for k, v in chip_smoke.REMAT_LAUNCHES[pol].items()
                    if v}
        assert calls == expected, pol
