"""The port's kaiming training slice against the JAX package.

Kaiming He's model J' (``models/kaiming.py``) with ``fused_pools = True``
and ``pallas_pool = 1``: three ``relu_max_pooling`` layers through the
relu_max_pool kernels and two dropout layers. At the test's size
(kaiming-tiny) the topology is the model's, at 208 px (the smallest
size whose SPP k6 pool still fits), with the widths narrowed: convs
8/16/32, the 2304-wide conv 64, fc 64, 10 classes, batch 4 with one
padded tail row.

Both packages start from one JAX snapshot. Dropout's masks must be the
same on both sides: the port's uniform draw goes through one seam,
``layers.common.dropout_uniform``, which the tests replace with the
reference's own draw ``uniform(fold_in(fold_in(PRNGKey(seed + 1),
step), layer))``. The JAX package runs its Pallas kernels in interpret
mode (H-chunked at these shapes), the port its kernels' plain versions.

Tolerances: per-step loss rtol 1e-5; every parameter and momentum
array rtol 1e-4, atol 1e-5 after the steps (f32 sums in another order:
convolutions, fc products, and the reference's chunked pool backward,
whose overlapping halos add partial sums). Layer checks state theirs.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import models as jax_models
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import create_layer as jax_create
from cxxnet_tpu.layers.base import Shape3 as JShape3
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layers import Shape3, common, conv, create_layer
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.layers.base import StepKey
from cxxnet_tpu_torch.models import kaiming
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config

BATCH, IMAGE, NCLASS = 4, 208, 10
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
KNOBS = [("pallas_pool", "1"), ("save_optimizer", "1"), ("seed", "3")]
NARROW = (("nchannel = 2304", "nchannel = 64"),
          ("nchannel = 256", "nchannel = 32"),
          ("nchannel = 128", "nchannel = 16"),
          ("nchannel = 64\n", "nchannel = 8\n"),
          ("nhidden = 4096", "nhidden = 64"))
# connection indices of kaiming's fused pools and its dropouts
POOL_LAYERS, DROPOUT_LAYERS = (1, 9, 17), (34, 37)


def _cfg(extra=()):
    text = kaiming(nclass=NCLASS, batch_size=BATCH, image_size=IMAGE,
                   fused_pools=True)
    for a, b in NARROW:
        assert a in text
        text = text.replace(a, b)
    return parse_config(text) + KNOBS + list(extra)


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
             rng.randint(0, NCLASS, (BATCH, 1)).astype(np.float32))
            for _ in range(n)]


def jax_uniform(shape, key, device):
    """The reference's dropout draw for ``key``, as a torch tensor."""
    k = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(key.seed + 1), np.uint32(key.step)), key.layer)
    return torch.from_numpy(np.array(
        jax.random.uniform(k, tuple(shape)))).to(device)


@contextlib.contextmanager
def _jax_masks():
    """The port draws dropout masks from the reference's bits."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "dropout_uniform", jax_uniform)
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops on one thread: at these sizes more threads
    only contend with the JAX runtime's own."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_trees_close(jax_arrays, port_arrays):
    assert set(jax_arrays) == set(port_arrays)
    for k in sorted(jax_arrays):
        np.testing.assert_allclose(port_arrays[k], np.asarray(jax_arrays[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One JAX trainer and one port trainer from the same snapshot,
    three steps each on the same padded batches with the same masks;
    the calls of the fused pool per step; the port's snapshot."""
    d = tmp_path_factory.mktemp("port_kaiming")
    jt = JaxTrainer(_cfg())
    jt.init_model()
    s0 = str(d / "s0.model.npz")
    jt.save_model(s0)
    pt = NetTrainer(_cfg(), device="cpu")
    pt.load_model(s0)
    kernels.reset_launch_counts()
    calls = []
    fused = conv.relu_max_pool
    jl, pl = [], []
    with _jax_masks(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv, "relu_max_pool",
                   lambda x, k: calls.append(tuple(x.shape)) or fused(x, k))
        for x, y in _batches(3, seed=1):
            jt.update(JaxBatch(data=x, label=y, num_batch_padd=1))
            jl.append(float(jt._last_loss))
            pt.update(DataBatch(x, y, num_batch_padd=1))
            pl.append(pt.last_loss)
    s3 = str(d / "s3.model.npz")
    pt.save_model(s3)
    return {"dir": d, "jax": jt, "port": pt, "jax_loss": jl,
            "port_loss": pl, "s3": s3, "calls": calls,
            "launches": kernels.launch_counts()}


def test_kaiming_model_text_matches_jax():
    for fused in (False, True):
        assert kaiming(fused_pools=fused) == jax_models.kaiming(
            fused_pools=fused)
    assert kaiming(nclass=10, batch_size=4, image_size=208,
                   fused_pools=True) == jax_models.kaiming(
        nclass=10, batch_size=4, image_size=208, fused_pools=True)


def test_kaiming_tiny_steps_match_jax(run):
    assert run["jax"].update_counter == run["port"].update_counter == 3
    np.testing.assert_allclose(run["port_loss"], run["jax_loss"],
                               rtol=LOSS_RTOL)
    assert run["port_loss"][0] != run["port_loss"][1]
    ja, _ = run["jax"].gather_snapshot()
    pa, _ = run["port"].gather_snapshot()
    assert any(k.startswith("opt/") for k in pa)
    _assert_trees_close(ja, pa)


def test_kaiming_tiny_runs_the_fused_pool(run):
    """Each step sends the three relu_max_pooling layers through the
    fused function (on the CPU its plain versions: no launch)."""
    net = run["port"].net
    assert [li for li, info in enumerate(net.graph.layers)
            if info.type == "relu_max_pooling"] == list(POOL_LAYERS)
    assert [li for li, info in enumerate(net.graph.layers)
            if info.type == "dropout"] == list(DROPOUT_LAYERS)
    assert run["calls"] == [(BATCH, 101, 101, 8), (BATCH, 34, 34, 16),
                            (BATCH, 17, 17, 32)] * 3
    assert all(v == 0 for v in run["launches"].values())


def test_kaiming_port_snapshot_resumes_in_jax(run):
    """The port's snapshot with its momentum: JAX loads it exactly, and
    one more step on each side (same masks) agrees."""
    jt = JaxTrainer(_cfg())
    jt.load_model(run["s3"])
    pa, _ = run["port"].gather_snapshot()
    ja, _ = jt.gather_snapshot()
    assert set(pa) == set(ja)
    for k in pa:
        np.testing.assert_array_equal(np.asarray(ja[k]), pa[k], err_msg=k)
    port = NetTrainer(_cfg(), device="cpu")
    port.load_model(run["s3"])
    (x, y), = _batches(1, seed=7)
    jt.update(JaxBatch(data=x, label=y, num_batch_padd=1))
    with _jax_masks():
        port.update(DataBatch(x, y, num_batch_padd=1))
    np.testing.assert_allclose(port.last_loss, float(jt._last_loss),
                               rtol=LOSS_RTOL)
    _assert_trees_close(jt.gather_snapshot()[0], port.gather_snapshot()[0])


def test_kaiming_jax_snapshot_resumes_in_port(run):
    """A JAX snapshot after three steps carries momentum; the port
    restores it exactly."""
    path = str(run["dir"] / "jax3.model.npz")
    run["jax"].save_model(path)
    port = NetTrainer(_cfg(), device="cpu")
    port.load_model(path)
    ja, _ = run["jax"].gather_snapshot()
    pa, _ = port.gather_snapshot()
    assert set(ja) == set(pa)
    for k in ja:
        np.testing.assert_array_equal(pa[k], np.asarray(ja[k]), err_msg=k)


def test_port_masks_repeat_by_step():
    """Two port runs from one seed give the same losses; ``run_steps``
    draws the same masks as the same number of ``update`` calls (the
    step scalar advances per step on both paths)."""
    (x, y), = _batches(1, seed=9)
    losses = []
    for how in ("update", "update", "run_steps"):
        t = NetTrainer(_cfg(), device="cpu")
        t.init_model()
        b = DataBatch(x, y, num_batch_padd=1)
        if how == "update":
            step_losses = []
            for _ in range(2):
                t.update(b)
                step_losses.append(t.last_loss)
            losses.append(step_losses)
        else:
            t.run_steps(b, 2)
            losses.append([None, t.last_loss])
    assert losses[0] == losses[1]
    assert losses[2][1] == losses[0][1]


# ----------------------------------------------------------- layers


def _pool_layers(type_str, pallas_pool, k=3, stride=1):
    cfg = [("kernel_size", str(k)), ("pallas_pool", str(pallas_pool))]
    if stride != 1:
        cfg.append(("stride", str(stride)))
    jl, pl = jax_create(type_str, cfg), create_layer(type_str, cfg)
    jl.infer_shape([JShape3(4, 11, 9)])
    pl.infer_shape([Shape3(4, 11, 9)])
    return jl, pl


@pytest.mark.parametrize("type_str,pallas_pool,stride", [
    ("relu_max_pooling", 0, 1), ("relu_max_pooling", 1, 1),
    ("pallas_relu_max_pooling", 0, 1), ("pallas_relu_max_pooling", 1, 1),
    ("relu_max_pooling", 1, 2)],
    ids=["relu_pool_pp0", "relu_pool_pp1", "pallas_relu_pool_pp0",
         "pallas_relu_pool_pp1", "relu_pool_pp1_gate_fails"])
def test_relu_max_pooling_layers_match_jax(type_str, pallas_pool, stride):
    """Forward and input gradient on a 0.5 grid, so windows hold tied
    maxima: exact. Through the fused kernels (pallas_relu_max_pooling,
    or pallas_pool = 1 where the gate holds) every tied maximum is
    credited; otherwise relu then max pooling credits the first, as in
    the reference."""
    jl, pl = _pool_layers(type_str, pallas_pool, stride=stride)
    rng = np.random.RandomState(4 + pallas_pool + stride)
    x = (np.round(rng.randn(2, 11, 9, 4) * 2) / 2).astype(np.float32)
    oy, ox = pl.out_shapes[0].y, pl.out_shapes[0].x
    dy = (np.arange(2 * oy * ox * 4) % 5 + 1).reshape(2, oy, ox, 4) \
        .astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jl.forward({}, {}, [a], True, None)[0][0],
                      jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    (y,), _ = pl.forward({}, {}, [xt], True)
    (pg,) = torch.autograd.grad(y, [xt], torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    fused = (type_str.startswith("pallas") or pallas_pool) and stride == 1
    # with ties, crediting all of them and crediting one differ
    ref = kernels.relu_max_pool_bwd_plain(
        torch.from_numpy(x), kernels.relu_max_pool_plain(
            torch.from_numpy(x), 3), torch.from_numpy(dy), 3) \
        if stride == 1 else None
    if ref is not None:
        assert torch.equal(pg, ref) == bool(fused)


def test_dropout_training_matches_jax():
    """Dropout's training forward and gradient against the reference's
    with the reference's mask injected: exact (the same 0/2 mask, one
    f32 product)."""
    cfg = [("threshold", "0.5")]
    jl, pl = jax_create("dropout", cfg), create_layer("dropout", cfg)
    jl.infer_shape([JShape3(1, 1, 64)])
    pl.infer_shape([Shape3(1, 1, 64)])
    rng = np.random.RandomState(12)
    x = rng.randn(6, 64).astype(np.float32)
    dy = rng.randn(6, 64).astype(np.float32)
    key = StepKey(seed=3, step=5, layer=34)
    jkey = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(key.seed + 1), key.step), key.layer)
    jy, vjp = jax.vjp(lambda a: jl.forward({}, {}, [a], True, jkey)[0][0],
                      jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    with _jax_masks():
        (y,), _ = pl.forward({}, {}, [xt], True, rng=key)
    (pg,) = torch.autograd.grad(y, [xt], torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    kept = np.asarray(jy) != 0
    assert 0.3 < kept.mean() < 0.7
    # eval, and a zero threshold, are the identity
    assert pl.forward({}, {}, [xt])[0][0] is xt
    pz = create_layer("dropout", [("threshold", "0")])
    pz.infer_shape([Shape3(1, 1, 64)])
    assert pz.forward({}, {}, [xt], True, rng=key)[0][0] is xt


def test_dropout_masks_follow_the_key():
    """The port's own draws: the same (seed, step, layer) repeats the
    mask, another step or layer changes it, and the keep rate over 1e5
    draws lies within 1 % of 1 - threshold."""
    layer = create_layer("dropout", [("threshold", "0.3")])
    layer.infer_shape([Shape3(1, 1, 1000)])
    x = torch.ones(100, 1000)

    def mask(seed, step, li):
        return layer.forward({}, {}, [x], True,
                             rng=StepKey(seed, step, li))[0][0]
    a = mask(0, 4, 34)
    assert torch.equal(a, mask(0, 4, 34))
    assert not torch.equal(a, mask(0, 5, 34))
    assert not torch.equal(a, mask(0, 4, 37))
    assert not torch.equal(a, mask(1, 4, 34))
    assert set(torch.unique(a).tolist()) == {
        0.0, float(np.float32(1) / np.float32(0.7))}
    keep = float((a != 0).float().mean())
    assert abs(keep - 0.7) < 0.01 * 0.7
    assert len({StepKey(s, t, li).generator_seed()
                for s in range(3) for t in range(3) for li in range(3)}) == 27
