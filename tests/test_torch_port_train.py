"""The port's training slice against the JAX package.

Inception-BN-tiny with ``fullc:fc1`` declared ``pallas_fullc:fc1`` and
``bn_pallas = 1``, ``bn_fuse_relu = 1`` (the trained Inception-BN-224
configuration at small widths). Both packages start from one JAX
snapshot and take the same steps on numpy-seeded batches: three full
ones, then an ``update_period = 2`` window on a
batch with a padded tail. The JAX package runs its Pallas kernels in
interpret mode, the port its kernels' plain versions. One
module-scoped pair of trainers serves every slice-level test, so each
JAX program compiles once.

Tolerances: per-step loss rtol 1e-5; every param, BN running stat and
momentum array rtol 1e-4, atol 1e-5 after the steps — the same f32
arithmetic, with sums (convolutions, BN moments, channel sums) in
another order. Layer- and updater-level checks state their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import create_layer as jax_create
from cxxnet_tpu.layers.base import Shape3 as JShape3
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.updater import create_updater as jax_updater
from cxxnet_tpu.utils.metric import MetricSet as JaxMetricSet
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layers import Shape3, create_layer
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.models import inception_bn_tiny
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.updater import create_updater
from cxxnet_tpu_torch.utils.config import parse_config
from cxxnet_tpu_torch.utils.metric import MetricSet

BATCH, IMAGE, NCLASS = 4, 16, 8
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
KNOBS = [("bn_pallas", "1"), ("bn_fuse_relu", "1"),
         ("save_optimizer", "1")]


def _cfg(extra=()):
    text = inception_bn_tiny(nclass=NCLASS, batch_size=BATCH,
                             image_size=IMAGE)
    text = text.replace("fullc:fc1", "pallas_fullc:fc1")
    return parse_config(text) + KNOBS + list(extra)


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32) \
            * rng.uniform(0.5, 2.0, (BATCH, 1, 1, 3)).astype(np.float32)
        y = rng.randint(0, NCLASS, (BATCH, 1)).astype(np.float32)
        out.append((x, y))
    return out


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
    three steps each on the same batches; then the port's snapshot."""
    d = tmp_path_factory.mktemp("port_train")
    jt = JaxTrainer(_cfg())
    jt.init_model()
    s0 = str(d / "s0.model.npz")
    jt.save_model(s0)
    pt = NetTrainer(_cfg(), device="cpu")
    pt.load_model(s0)
    kernels.reset_launch_counts()
    jl, pl = [], []
    for x, y in _batches(3, seed=1):
        jt.update(JaxBatch(data=x, label=y))
        jl.append(float(jt._last_loss))
        pt.update(DataBatch(x, y))
        pl.append(pt.last_loss)
    s3 = str(d / "s3.model.npz")
    pt.save_model(s3)
    return {"dir": d, "jax": jt, "port": pt, "jax_loss": jl,
            "port_loss": pl, "s3": s3,
            "launches": kernels.launch_counts()}


def test_train_steps_match_jax(run):
    assert run["jax"].update_counter == run["port"].update_counter == 3
    np.testing.assert_allclose(run["port_loss"], run["jax_loss"],
                               rtol=LOSS_RTOL)
    # the loss moved: the comparison follows real updates
    assert run["port_loss"][0] != run["port_loss"][1]
    ja, _ = run["jax"].gather_snapshot()
    pa, _ = run["port"].gather_snapshot()
    assert any(k.startswith("opt/") for k in pa)
    _assert_trees_close(ja, pa)


def test_training_on_cpu_launches_no_kernel(run):
    """On the CPU every wrapper takes its plain version."""
    assert all(v == 0 for v in run["launches"].values())


def test_port_snapshot_resumes_in_jax(run):
    """The port's snapshot with its optimizer state: JAX loads it,
    predicts the port's classes, and its next update_period = 2 window,
    on a batch whose last row is padding, matches the port's (the
    port's own run_steps agrees bit for bit with two update() calls)."""
    up2 = [("update_period", "2")]
    jt = JaxTrainer(_cfg(up2))
    jt.load_model(run["s3"])
    pa, _ = run["port"].gather_snapshot()
    ja, _ = jt.gather_snapshot()
    for k in pa:
        np.testing.assert_array_equal(np.asarray(ja[k]), pa[k], err_msg=k)
    (x, y), = _batches(1, seed=7)
    port = NetTrainer(_cfg(up2), device="cpu")
    port.load_model(run["s3"])
    np.testing.assert_array_equal(
        port.predict(DataBatch(x)),
        np.asarray(jt.predict(JaxBatch(data=x, label=y))))
    line, vals = port.evaluate_metrics([DataBatch(x, y)], "eval")
    jline, jvals = jt.evaluate_metrics([JaxBatch(data=x, label=y)], "eval")
    assert line == jline and vals == jvals
    jt.run_steps(JaxBatch(data=x, label=y, num_batch_padd=1), 2)
    port.update(DataBatch(x, y, num_batch_padd=1))
    assert port.update_counter == 3 and port.sample_counter == 1
    port.update(DataBatch(x, y, num_batch_padd=1))
    assert port.update_counter == 4 and port.sample_counter == 0
    np.testing.assert_allclose(port.last_loss, float(jt._last_loss),
                               rtol=LOSS_RTOL)
    _assert_trees_close(jt.gather_snapshot()[0], port.gather_snapshot()[0])
    again = NetTrainer(_cfg(up2), device="cpu")
    again.load_model(run["s3"])
    again.run_steps(DataBatch(x, y, num_batch_padd=1), 2)
    for k, v in port.gather_snapshot()[0].items():
        np.testing.assert_array_equal(again.gather_snapshot()[0][k], v)


def test_jax_snapshot_momentum_resumes_in_port(run):
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


# ----------------------------------------------------------- layers


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "bn_pallas"])
@pytest.mark.parametrize("fold,relu", [(1, True), (1, False), (0, True)],
                         ids=["fold_relu", "fold", "unfolded_relu"])
@pytest.mark.parametrize("shape", [(4, 3, 5, 6), (5, 7)],
                         ids=["nhwc", "mat"])
def test_batch_norm_training_matches_jax(shape, fold, relu, use_pallas):
    """Training forward with a padded-tail mask: output, running stats
    and the gradients of slope, bias and x. rtol 1e-5, atol 1e-5: f32
    moments summed in another order."""
    cfg = [("bn_fold_affine", str(fold)), ("bn_pallas", str(int(use_pallas))),
           ("init_slope", "1.5"), ("init_bias", "0.2")]
    jl, pl = jax_create("batch_norm", cfg), create_layer("batch_norm", cfg)
    s = (Shape3(1, 1, shape[-1]) if len(shape) == 2
         else Shape3(shape[3], shape[1], shape[2]))
    jl.infer_shape([JShape3(*s)])
    pl.infer_shape([s])
    jl.fuse_relu = pl.fuse_relu = relu
    rng = np.random.RandomState(len(shape) + fold)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    mask = np.ones(shape[0], np.float32)
    mask[-1] = 0.0
    st = {"running_exp": rng.randn(s.x if s.is_mat else s.ch)
          .astype(np.float32),
          "running_var": rng.rand(s.x if s.is_mat else s.ch)
          .astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in jl.init_params(None).items()}

    def jfwd(p, xx):
        (o,), ns = jl.forward(p, {k: jnp.asarray(v) for k, v in st.items()},
                              [xx], True, None, mask=jnp.asarray(mask))
        return jnp.sum(o * dy), (o, ns)

    (_, (jo, jns)), (jgp, jgx) = jax.value_and_grad(
        jfwd, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    pp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (po,), pns = pl.forward(pp, {k: torch.from_numpy(v)
                                 for k, v in st.items()},
                            [xt], True, mask=torch.from_numpy(mask))
    g = torch.autograd.grad((po * torch.from_numpy(dy)).sum(),
                            [pp["wmat"], pp["bias"], xt])
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo), **tol)
    for k in ("running_exp", "running_var"):
        np.testing.assert_allclose(pns[k].numpy(), np.asarray(jns[k]), **tol)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(jgp["wmat"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g[1].numpy(), np.asarray(jgp["bias"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g[2].numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,k,stride,pad", [("max", 3, 2, 0),
                                               ("max", 3, 1, 1),
                                               ("avg", 3, 1, 1)],
                         ids=["max_s2_ceil", "max_s1_pad", "avg_s1_pad"])
def test_pooling_backward_matches_jax(kind, k, stride, pad):
    """The training backward of pooling on a relu'd input rounded to
    steps of 0.5, so that windows hold tied maxima (zeros and positive
    values): every gradient entry as the reference credits it. Exact
    for max; rtol 1e-6 for avg (f32 sums)."""
    cfg = [("kernel_size", str(k)), ("stride", str(stride)),
           ("pad", str(pad))]
    jl = jax_create("%s_pooling" % kind, cfg)
    pl = create_layer("%s_pooling" % kind, cfg)
    jl.infer_shape([JShape3(4, 9, 9)])
    pl.infer_shape([Shape3(4, 9, 9)])
    rng = np.random.RandomState(8)
    x = np.maximum(np.round(rng.randn(2, 9, 9, 4) * 2) / 2, 0).astype(
        np.float32)
    oy, ox = pl.out_shapes[0].y, pl.out_shapes[0].x
    dy = (np.arange(2 * oy * ox * 4) % 7 + 1).reshape(2, oy, ox, 4) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda a: jl.forward({}, {}, [a], True, None)[0][0],
                     jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    (y,), _ = pl.forward({}, {}, [xt], True)
    (pg,) = torch.autograd.grad(y, [xt], torch.from_numpy(dy))
    if kind == "max":
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    else:
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_softmax_loss_value_and_grad_match_jax(masked):
    """rtol 1e-6 on the loss, 1e-5 on the gradient (f32 log-softmax)."""
    rng = np.random.RandomState(3)
    logit = (rng.randn(6, 10) * 3).astype(np.float32)
    label = rng.randint(0, 10, (6, 1)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if masked else None
    cfg = [("grad_scale", "0.5")]
    jl, pl = jax_create("softmax", cfg), create_layer("softmax", cfg)
    jl.batch_size = pl.batch_size = 6
    jv, jg = jax.value_and_grad(
        lambda z: jl.loss_value(z, jnp.asarray(label),
                                None if mask is None else jnp.asarray(mask))
    )(jnp.asarray(logit))
    zt = torch.from_numpy(logit).requires_grad_(True)
    pv = pl.loss_value(zt, torch.from_numpy(label),
                       None if mask is None else torch.from_numpy(mask))
    (pg,) = torch.autograd.grad(pv, [zt])
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_training_forward_raises_for_dropout(monkeypatch):
    """Dropout's training forward raises without the step's rng; with
    it, it applies the mask drawn through the ``dropout_uniform`` seam
    (here an injected draw): ``x * ((u < 0.5) / 0.5)``. Eval is the
    identity."""
    from cxxnet_tpu_torch.layers import common
    from cxxnet_tpu_torch.layers.base import StepKey
    layer = create_layer("dropout", [("threshold", "0.5")])
    layer.infer_shape([Shape3(1, 1, 4)])
    with pytest.raises(ValueError, match="rng"):
        layer.forward({}, {}, [torch.zeros(2, 4)], True)
    u = torch.tensor([[0.1, 0.7, 0.5, 0.49], [0.9, 0.0, 0.3, 0.6]])
    seen = []
    monkeypatch.setattr(common, "dropout_uniform",
                        lambda shape, key, device: seen.append(key) or u)
    x = torch.arange(1.0, 9.0).reshape(2, 4)
    (y,), _ = layer.forward({}, {}, [x], True, rng=StepKey(3, 5, 7))
    assert torch.equal(y, x * torch.tensor([[2.0, 0, 0, 2], [0, 2, 2, 0]]))
    assert seen == [StepKey(3, 5, 7)]
    assert layer.forward({}, {}, [torch.ones(2, 4)])[0][0].sum() == 8


# --------------------------------------------------------- updaters


@pytest.mark.parametrize("kind,extra", [
    ("sgd", [("lr:schedule", "factor"), ("lr:step", "3"),
             ("lr:factor", "0.1")]),
    ("nag", [("lr:schedule", "expdecay"), ("lr:step", "2"),
             ("lr:gamma", "0.5"), ("clip_gradient", "0.5")]),
    ("adam", [("lr:schedule", "polydecay"), ("lr:step", "3"),
              ("wd", "0.01")]),
], ids=["sgd", "nag", "adam"])
def test_updaters_match_jax_across_a_schedule_boundary(kind, extra):
    """Five updates with the schedule stepping at epoch 2 or 3; a NaN
    in one gradient exercises the clip. rtol 1e-6, atol 1e-7 (the same
    f32 rule; XLA may contract a multiply-add)."""
    cfg = [("wmat:lr", "0.1"), ("wmat:wd", "0.001"), ("momentum", "0.8"),
           ("bias:lr", "9")] + extra
    ju, pu = jax_updater(kind, "wmat", cfg), create_updater(kind, "wmat", cfg)
    rng = np.random.RandomState(11)
    w = rng.randn(7, 5).astype(np.float32)
    js, ps = ju.init_state(jnp.asarray(w)), pu.init_state(torch.from_numpy(w))
    jw, pw = jnp.asarray(w), torch.from_numpy(w)
    lrs = []
    for epoch in range(5):
        g = rng.randn(7, 5).astype(np.float32)
        if epoch == 1 and ju.param.clip_gradient:
            g[0, 0] = np.nan
        for u in (ju, pu):
            u.param.schedule_epoch(epoch)
        lrs.append(pu.param.learning_rate)
        hy = {"learning_rate": np.float32(ju.param.learning_rate),
              "momentum": np.float32(ju.param.momentum),
              "wd": np.float32(ju.param.wd), "epoch": np.uint32(epoch)}
        jw, js = ju.apply(jw, jnp.asarray(g), js, hy)
        pw, ps = pu.apply(pw, torch.from_numpy(g), ps,
                          {"learning_rate": float(hy["learning_rate"]),
                           "momentum": float(hy["momentum"]),
                           "wd": float(hy["wd"]), "epoch": epoch})
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        for k in js:
            np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-7)
    assert len(set(lrs)) > 1 and pu.param.base_lr == 0.1


def test_frozen_group_keeps_its_weights():
    """lr_mult = 0 allocates no momentum and the trainer passes the
    weight through untouched."""
    cfg = parse_config(
        "netconfig=start\nlayer[0->1] = fullc:fc1\n  nhidden = 4\n"
        "  wmat:lr_mult = 0\nlayer[1->1] = softmax\nnetconfig=end\n"
        "input_shape = 1,1,6\nbatch_size = 3\neta = 0.5\n")
    t = NetTrainer(cfg, device="cpu")
    t.init_model()
    w0 = t.params["fc1"]["wmat"].clone()
    b0 = t.params["fc1"]["bias"].clone()
    assert t.opt_state["fc1"]["wmat"] == {}
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    t.update(DataBatch(x, np.array([[0], [1], [2]], np.float32)))
    assert torch.equal(t.params["fc1"]["wmat"], w0)
    assert not torch.equal(t.params["fc1"]["bias"], b0)


# ---------------------------------------------------------- metrics


def test_metric_set_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.rand(9, 6).astype(np.float32)
    label = rng.randint(0, 6, (9, 2)).astype(np.float32)
    names = ["error", "logloss", "rec@2", "recall@3", "prec@2", "rmse"]
    jm, pm = JaxMetricSet(), MetricSet()
    for n in names[:-1]:
        jm.add_metric(n, "label")
        pm.add_metric(n, "label")
    jm.add_metric("rmse", "aux")
    pm.add_metric("rmse", "aux")
    fields = {"label": label[:, :1], "aux": pred[:, :6] * 0.5}
    preds = [pred] * len(names)
    jm.add_eval(preds, fields)
    pm.add_eval(preds, fields)
    assert pm.print_str("test") == jm.print_str("test")
    pm2 = MetricSet()
    pm2.add_metric("recall@3")
    pm2.add_eval([pred], {"label": label})
    jm2 = JaxMetricSet()
    jm2.add_metric("recall@3")
    jm2.add_eval([pred], {"label": label})
    assert pm2.results() == jm2.results()
