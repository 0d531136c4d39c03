"""The rest of the layer zoo in the port against the JAX package.

Every layer type of the layer-zoo slice (``lrn``, ``xelu``, ``insanity`` /
``rrelu``, ``prelu``, ``bias``, ``sum_pooling``,
``insanity_max_pooling``, ``batch_norm_no_ma``, ``fixconn``,
``lp_loss`` / ``l2_loss``, ``multi_logistic``, ``torch`` and
``pairtest-A-B``): the same numpy-seeded inputs, weights and state go
through the reference layer and the port's, and the outputs, the new
state and the gradients of the parameters and inputs (from one seeded
cotangent) are compared, in float32 and with bf16 inputs (the
``dtype = bfloat16`` case; the layers that read ``dtype`` get it).
The reference runs one jitted forward + VJP compiled with XLA's
``xla_allow_excess_precision`` off, so it rounds to bf16 after every op
as eager PyTorch does. Training draws go through the port's seam
``layers.common.dropout_uniform``, fed the reference's own
``uniform(fold_in(fold_in(PRNGKey(seed + 1), step), layer))``.

Tolerances:

- bf16: the same bits (outputs and gradients) wherever the arithmetic
  is the same elementwise chain; the f32 parts of a bf16 case as below.
- float32: rtol 1e-5, atol 1e-6 times the array's largest magnitude
  (batch norm's gradients rtol 1e-4, ``BN_RTOL``). XLA:CPU contracts a
  multiply and an add into one FMA, takes its float32 ``rsqrt`` as the
  CPU's hardware estimate refined by two Newton steps, and sums a
  reduction in another order, so a float32 value lies a few ulps from
  PyTorch's. The ``torch`` layer is the same PyTorch call in both
  packages: the same bits.
- The LRN's float32 output: its ``rsqrt`` factor (above) lies up to 3
  float32 ulps from the reference's; under bf16 the factor is cast to
  bf16 and the output holds bit for bit.

Beside the layers: ``known_layer_type`` and ``create_layer`` agree with
the reference's registry on every type string; the zoo builders' text
equals the reference's; a net that holds every new type
(``chip_smoke.zoo_text``, batch 4, 16 px) trains two ``update`` steps
and one ``update_many`` window in both packages from one reference
snapshot, every loss within rtol 1e-5 and every param, momentum and
state array within rtol 1e-4 (atol 1e-5 times its largest magnitude)
after each; and its snapshot crosses both ways with the same arrays and
dtypes (insanity's ``step`` stays int32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import layers as jax_layers
from cxxnet_tpu import models as jax_models
from cxxnet_tpu.layers import Shape3 as JShape3
from cxxnet_tpu_torch import layers as port_layers
from cxxnet_tpu_torch import models as port_models
from cxxnet_tpu_torch.layers import Shape3, common
from cxxnet_tpu_torch.layers.base import StepKey
import chip_smoke
from test_torch_port_kaiming import jax_uniform

NO_EXCESS = {"xla_allow_excess_precision": False}
RTOL, ATOL = 1e-5, 1e-6
# the gradient through batch norm's single-pass moments cancels
# (E[x^2] - E[x]^2): float32 rounding in another summation order grows
# to ~2e-5 relative in an input gradient
BN_RTOL = 1e-4
KEY = StepKey(7, 3, 5)          # (seed, step, connection index)


def _jax_key(key):
    return jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(key.seed + 1), np.uint32(key.step)), key.layer)


def _np(v):
    return np.asarray(jnp.asarray(v).astype(jnp.float32)) \
        if jnp.asarray(v).dtype == jnp.bfloat16 else np.asarray(v)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _f32(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _pair(type_str, cfg, in_shapes):
    j = jax_layers.create_layer(type_str, list(cfg))
    p = port_layers.create_layer(type_str, list(cfg))
    js = j.infer_shape([JShape3(*s) for s in in_shapes])
    ps = p.infer_shape([Shape3(*s) for s in in_shapes])
    assert [tuple(s) for s in js] == [tuple(s) for s in ps]
    return j, p


def _input(rng, b, s, scale=1.0):
    ch, y, x = s
    shape = (b, x) if (ch == 1 and y == 1) else (b, y, x, ch)
    return (scale * rng.randn(*shape)).astype(np.float32)


def run_both(j, p, xs, dtype="float32", is_train=False, state=None,
             params=None, mask=None, seed=0):
    """One forward + VJP of the reference layer ``j`` (jitted, excess
    precision off) and the port's ``p`` from the same params (the
    reference's init unless given), state, inputs (rounded to ``dtype``)
    and seeded cotangent; training draws from the reference's stream.
    Returns {"jax": ..., "port": ...}, each with numpy ``outs``,
    ``state``, ``gparams`` and ``gxs`` (bf16 values as float32)."""
    if params is None:
        params = {k: np.asarray(v) for k, v in
                  j.init_params(jax.random.PRNGKey(seed)).items()}
    if state is None:
        state = {k: np.asarray(v) for k, v in j.init_state().items()}
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    jxs = [jnp.asarray(x).astype(jd) for x in xs]
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jkw = {"mask": None if mask is None else jnp.asarray(mask)} \
        if j.needs_mask else {}
    jkey = _jax_key(KEY) if is_train else None

    def fwd(pr, xx):
        outs, st = j.forward(pr, jstate, list(xx), is_train, jkey, **jkw)
        return outs, st

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    outs_shape = jax.eval_shape(lambda pr, xx: fwd(pr, xx)[0], jp, jxs)
    rng = np.random.RandomState(seed + 11)
    gs = [rng.randn(*o.shape).astype(np.float32) for o in outs_shape]
    jgs = [jnp.asarray(g).astype(o.dtype) for g, o in zip(gs, outs_shape)]

    def step(pr, xx, gg):
        outs, vjp, st = jax.vjp(fwd, pr, xx, has_aux=True)
        gp, gx = vjp(gg)
        return outs, st, gp, gx

    c = jax.jit(step).lower(jp, jxs, jgs).compile(compiler_options=NO_EXCESS)
    jo, jst, jgp, jgx = c(jp, jxs, jgs)
    res = {"jax": {"outs": [_np(o) for o in jo],
                   "out_dtypes": [str(o.dtype) for o in jo],
                   "state": {k: _np(v) for k, v in jst.items()},
                   "gparams": {k: _np(v) for k, v in jgp.items()},
                   "gxs": [_np(g) for g in jgx]}}
    pp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    pxs = [_t(x, td).requires_grad_(True) for x in xs]
    pst = {k: _t(v) for k, v in state.items()}
    pkw = {}
    if p.needs_mask:
        pkw["mask"] = None if mask is None else _t(mask)
    if p.needs_rng:
        pkw["rng"] = KEY if is_train else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "dropout_uniform", jax_uniform)
        outs, pst2 = p.forward(pp, pst, pxs, is_train, **pkw)
    pgs = [_t(g).to(o.dtype) for g, o in zip(gs, outs)]
    wrt = list(pp.values()) + pxs
    grads = torch.autograd.grad(outs, wrt, pgs, allow_unused=True)
    zeros = [torch.zeros_like(w) for w in wrt]
    grads = [z if g is None else g for g, z in zip(grads, zeros)]
    res["port"] = {"outs": [_f32(o) for o in outs],
                   "out_dtypes": [str(o.dtype).replace("torch.", "")
                                  for o in outs],
                   "state": {k: _f32(v) for k, v in pst2.items()},
                   "gparams": {k: _f32(g) for k, g in
                               zip(pp, grads[:len(pp)])},
                   "gxs": [_f32(g) for g in grads[len(pp):]]}
    return res


def assert_same(res, exact=("outs", "gxs", "gparams", "state"),
                rtol=RTOL, atol=ATOL):
    """Each part in ``exact`` the same values; the others within rtol,
    and within atol times the largest magnitude of the array (a sum's
    error scales with its terms, not with a small result)."""
    j, p = res["jax"], res["port"]
    assert p["out_dtypes"] == j["out_dtypes"]
    assert sorted(p["state"]) == sorted(j["state"])
    assert sorted(p["gparams"]) == sorted(j["gparams"])
    for part in ("outs", "gxs", "gparams", "state"):
        a, b = j[part], p[part]
        keys = sorted(a) if isinstance(a, dict) else range(len(a))
        for k in keys:
            if part in exact:
                np.testing.assert_array_equal(b[k], a[k],
                                              err_msg="%s %s" % (part, k))
            else:
                scale = float(np.abs(a[k]).max()) if np.size(a[k]) else 0.0
                np.testing.assert_allclose(b[k], a[k], rtol=rtol,
                                           atol=atol * max(scale, 1.0),
                                           err_msg="%s %s" % (part, k))


# ------------------------------------------------------------ the layers

S, M = (16, 5, 5), (1, 1, 12)       # a spatial and a matrix node
# (type, cfg, node shape, input scale, train state or None); every case
# runs in training (the draws from the reference's stream) and at eval
CASES = {
    "lrn_alexnet": ("lrn", [("local_size", "5"), ("alpha", "0.0001"),
                            ("beta", "0.75"), ("knorm", "1")], S, 30.0,
                    None),
    "lrn_pow": ("lrn", [("local_size", "3"), ("alpha", "0.01"),
                        ("beta", "0.6"), ("knorm", "2")], S, 3.0, None),
    "xelu": ("xelu", [], S, 1.0, None),
    "xelu_b3": ("xelu", [("b", "3")], M, 1.0, None),
    # an annealing window the step is inside of (it moves)
    "insanity": ("insanity", [("lb", "3"), ("ub", "8"),
                              ("calm_start", "-1"), ("calm_end", "4")],
                 S, 1.0, {"lb": np.float32(3.5), "ub": np.float32(7.0),
                          "step": np.int32(2)}),
    # rrelu's defaults: no window, nothing moves
    "rrelu": ("rrelu", [], M, 1.0, None),
    "prelu": ("prelu", [("init_slope", "0.3")], S, 1.0, None),
    "prelu_noise": ("prelu", [("random", "0.1")], M, 1.0, None),
    "bias": ("bias", [("init_bias", "0.5")], M, 1.0, None),
    "sum_pooling": ("sum_pooling", [("kernel_size", "3"), ("stride", "2")],
                    (6, 7, 7), 1.0, None),
    "sum_pooling_pad": ("sum_pooling", [("kernel_size", "2"),
                                        ("stride", "2"), ("pad", "1")],
                        (6, 7, 7), 1.0, None),
    "insanity_max_pooling": ("insanity_max_pooling",
                             [("kernel_size", "3"), ("stride", "2"),
                              ("keep", "0.6")], (6, 7, 7), 1.0, None),
    "batch_norm_no_ma": ("batch_norm_no_ma", [], S, 2.0, None),
    "batch_norm_no_ma_mat": ("batch_norm_no_ma", [], M, 2.0, None),
    "torch_fullc": ("torch", [("nhidden", "10")], M, 1.0, None),
    "torch_conv": ("torch", [("nchannel", "8"), ("kernel_size", "3"),
                             ("pad", "1"), ("ngroup", "2")], S, 1.0, None),
    "pairtest-conv-torch": ("pairtest-conv-torch",
                            [("nchannel", "8"), ("kernel_size", "3"),
                             ("pad", "1")], S, 1.0, None),
    "pairtest-fullc-torch": ("pairtest-fullc-torch", [("nhidden", "10")],
                             M, 1.0, None),
    # a stochastic slave with its own state and keys
    "pairtest-xelu-insanity": ("pairtest-xelu-insanity",
                               [("slave:lb", "4.9"), ("slave:ub", "5.1"),
                                ("master:b", "5")], S, 1.0, None),
    "pairtest-batch_norm-batch_norm_no_ma": (
        "pairtest-batch_norm-batch_norm_no_ma", [], S, 2.0, None),
}
# bit for bit in bf16 (outputs, input and parameter gradients, state);
# the others' float32 parts within the float32 tolerance: a float32
# output (insanity's and prelu's promote, fixconn's and the torch
# layer's product), a float32 parameter gradient summed over the batch
BF16_EXACT = {
    "lrn_alexnet": ("outs", "gxs", "state"),
    "lrn_pow": ("outs", "gxs", "state"),
    "xelu": ("outs", "gxs", "state"),
    "xelu_b3": ("outs", "gxs", "state"),
    "insanity": ("gxs", "state"),
    "rrelu": ("gxs", "state"),
    "prelu": ("outs",),
    "prelu_noise": (),
    "bias": ("outs", "gxs", "gparams"),
    "sum_pooling": ("outs", "gxs"),
    "sum_pooling_pad": ("outs", "gxs"),
    "insanity_max_pooling": ("outs", "gxs"),
    "batch_norm_no_ma": ("outs", "gxs", "state"),
    "batch_norm_no_ma_mat": ("outs", "gxs", "state"),
}
MASK = np.array([1, 1, 1, 0], np.float32)     # one padded tail row


def _case(name, dtype, is_train):
    type_str, cfg, shape, scale, state = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    j, p = _pair(type_str, cfg + [("dtype", dtype)], [shape])
    x = _input(rng, 4, shape, scale)
    if name.startswith("insanity_max"):
        x = np.round(2 * x) / 2          # tied maxima
    if name.startswith("batch_norm"):
        x = x + 1.0
    # the torch layer computes in float32 (the reference's host callback
    # refuses a bf16 array), so it is fed float32 under dtype = bfloat16
    xdt = "float32" if name.startswith(("torch", "pairtest-conv-torch",
                                        "pairtest-fullc-torch")) else dtype
    params = None
    if type_str in ("bias", "batch_norm_no_ma", "prelu"):
        # not the constant init: a per-channel vector of its own
        params = {k: (rng.rand(*np.shape(v)) + 0.5).astype(np.float32)
                  if k != "bias" or type_str == "prelu" else
                  rng.randn(*np.shape(v)).astype(np.float32)
                  for k, v in j.init_params(jax.random.PRNGKey(0)).items()}
        if type_str == "prelu":
            params["bias"] = (0.5 * params["bias"]).astype(np.float32)
    return run_both(j, p, [x], xdt, is_train, state=state, params=params,
                    mask=MASK)


# the layers whose eval forward differs from the training one (draws,
# batch moments, annealing); the others run in training only
TRAIN_AND_EVAL = ("insanity", "rrelu", "prelu_noise", "insanity_max_pooling",
                  "batch_norm_no_ma", "batch_norm_no_ma_mat",
                  "pairtest-xelu-insanity",
                  "pairtest-batch_norm-batch_norm_no_ma")


def _modes(names):
    return [(n, t) for n in sorted(names)
            for t in ((True, False) if n in TRAIN_AND_EVAL else (True,))]


@pytest.mark.parametrize("name,train", _modes(CASES), ids=[
    "%s-%s" % (n, "train" if t else "eval") for n, t in _modes(CASES)])
def test_layer_float32_matches_reference(name, train):
    res = _case(name, "float32", train)
    exact = ("outs", "gxs", "gparams") if name.startswith("torch") \
        else ("state",) if CASES[name][4] is not None else ()
    assert_same(res, exact=exact,
                rtol=BN_RTOL if "batch_norm" in name else RTOL)
    if name.startswith("pairtest"):
        assert res["port"]["state"]["pairtest:max_diff"] >= 0


@pytest.mark.parametrize("name,train", _modes(BF16_EXACT), ids=[
    "%s-%s" % (n, "train" if t else "eval") for n, t in _modes(BF16_EXACT)])
def test_layer_bf16_matches_reference(name, train):
    res = _case(name, "bfloat16", train)
    if name.startswith("prelu"):
        # the reference's custom VJP hands back a float32 cotangent for
        # a bf16 x; autograd casts it to x's dtype: the port's dx is the
        # reference's rounded to bf16
        res["jax"]["gxs"] = [np.asarray(jnp.asarray(g).astype(
            jnp.bfloat16).astype(jnp.float32)) for g in res["jax"]["gxs"]]
        np.testing.assert_array_equal(res["port"]["gxs"][0],
                                      res["jax"]["gxs"][0])
    assert_same(res, exact=BF16_EXACT[name])


def test_fixconn_matches_reference(tmp_path):
    """The matrix from a text file (every third entry set) in both
    packages; no parameter, the input gradient through it."""
    rng = np.random.RandomState(4)
    w = rng.randn(8, 12)
    nz = [(r, c, w[r, c]) for r in range(8) for c in range(12)
          if (r + c) % 3 == 0]
    path = str(tmp_path / "fixconn.txt")
    with open(path, "w") as f:
        f.write("8 12 %d\n" % len(nz))
        f.write("\n".join("%d %d %.6f" % t for t in nz))
    for dtype in ("float32", "bfloat16"):
        j, p = _pair("fixconn", [("nhidden", "8"), ("fixconn_weight", path),
                                 ("dtype", dtype)], [M])
        res = run_both(j, p, [_input(rng, 3, M)], dtype, True)
        assert res["port"]["gparams"] == {}
        assert_same(res, exact=("gxs",) if dtype == "bfloat16" else ())


LOSSES = {"l2_loss": [], "lp_loss_p1": [("p", "1")],
          "lp_loss_p3": [("p", "3")], "multi_logistic": []}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_layers_match_reference(name):
    """The prediction transform, and the loss value and its gradient
    with respect to the logits from a dense label block, with a padded
    row masked out and ``grad_scale``; the logits also bf16."""
    type_str = name.split("_p")[0]
    cfg = LOSSES[name] + [("grad_scale", "0.5"), ("batch_size", "4")]
    rng = np.random.RandomState(len(name))
    j, p = _pair(type_str, cfg, [(1, 1, 6)])
    logit = (2 * rng.randn(4, 6)).astype(np.float32)
    label = (rng.rand(4, 6) > 0.5).astype(np.float32) \
        if type_str == "multi_logistic" \
        else rng.randn(4, 6).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jl = jnp.asarray(logit).astype(dtype)
        (jy,), _ = j.forward({}, {}, [jl], False, None)
        jv, jg = jax.value_and_grad(
            lambda z: j.loss_value(z, jnp.asarray(label),
                                   jnp.asarray(MASK)))(jl)
        tl = _t(logit, getattr(torch, dtype)).requires_grad_(True)
        (py,), _ = p.forward({}, {}, [tl], False)
        pv = p.loss_value(tl, _t(label), _t(MASK))
        (pg,) = torch.autograd.grad(pv, [tl])
        assert py.dtype == torch.float32 and pg.dtype == tl.dtype
        np.testing.assert_allclose(_f32(py), _np(jy), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=RTOL)
        np.testing.assert_allclose(_f32(pg), _np(jg), rtol=RTOL, atol=ATOL)


# ------------------------------------------------- the zoo net, trained

ZOO_BATCH, ZOO_IMAGE = 4, 16
NET_RTOL = 1e-4                     # every array, atol 1e-5 * its scale


def _zoo_cfg(path):
    from cxxnet_tpu_torch.utils.config import parse_config
    return parse_config(chip_smoke.zoo_text(ZOO_BATCH, ZOO_IMAGE, path)) \
        + [("seed", "5"), ("save_optimizer", "1")]


def _assert_arrays_close(port_arrays, ref_arrays, rtol=NET_RTOL):
    assert sorted(port_arrays) == sorted(ref_arrays)
    for k in sorted(ref_arrays):
        a = np.asarray(ref_arrays[k])
        scale = float(np.abs(a).max()) if a.size else 0.0
        np.testing.assert_allclose(port_arrays[k], a, rtol=rtol,
                                   atol=1e-5 * max(scale, 1.0), err_msg=k)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """The zoo net (every layer type of the slice, ``chip_smoke.zoo_text``
    at batch 4, 16 px) in both packages from one reference snapshot: two
    ``update`` steps, then one ``update_many`` window of two batches,
    the port's draws from the reference's stream."""
    from cxxnet_tpu.io.data import DataBatch as JaxBatch
    from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    d = tmp_path_factory.mktemp("zoo")
    fx = chip_smoke.write_fixconn(str(d / "fixconn.txt"), 24, 32)
    jt = JaxTrainer(_zoo_cfg(fx))
    jt.init_model()
    s0 = str(d / "s0.model.npz")
    jt.save_model(s0)
    pt = NetTrainer(_zoo_cfg(fx), device="cpu")
    pt.load_model(s0)
    rng = np.random.RandomState(3)
    batches = [chip_smoke.zoo_batch(rng, ZOO_BATCH, ZOO_IMAGE)
               for _ in range(4)]
    states = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "dropout_uniform", jax_uniform)
        for b in batches[:2]:
            jt.update(JaxBatch(data=b.data, label=b.label))
            pt.update(b)
            states.append((float(jt._last_loss), pt.last_loss,
                           jt.gather_snapshot()[0], pt.gather_snapshot()[0]))
        jt.update_many([JaxBatch(data=b.data, label=b.label)
                        for b in batches[2:]])
        pt.update_many(batches[2:])
    return {"dir": d, "fx": fx, "jax": jt, "port": pt, "states": states}


def test_zoo_net_trains_like_the_reference(zoo):
    """Each step's loss within rtol 1e-5 and the params, momentum and
    state (insanity's annealed bounds and step, the pairtest's max_diff)
    after it within NET_RTOL; then the same after the update_many
    window."""
    for jl, pl, ja, pa in zoo["states"]:
        np.testing.assert_allclose(pl, jl, rtol=RTOL)
        _assert_arrays_close(pa, ja)
    ja, _ = zoo["jax"].gather_snapshot()
    pa, _ = zoo["port"].gather_snapshot()
    _assert_arrays_close(pa, ja)
    # the bounds annealed in every step inside (calm_start, calm_end)
    assert int(pa["state/in1/step"]) == 4
    assert pa["state/in1/step"].dtype == np.int32
    assert float(pa["state/in1/ub"]) < 8.0
    assert float(pa["state/pt1/pairtest:max_diff"]) > 0.0


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_zoo_snapshots_cross_both_ways(zoo, direction):
    """The zoo net's snapshot after its steps (prelu's slope ``bias``,
    insanity's ``lb`` / ``ub`` / int32 ``step``, the pairtest's
    ``slave:*`` and ``pairtest:max_diff``, batch_norm_no_ma's params and
    no state, momentum): written by one package, loaded by the other,
    the same arrays."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    src, dst = (("port", JaxTrainer(_zoo_cfg(zoo["fx"])))
                if direction == "port_to_ref"
                else ("jax", NetTrainer(_zoo_cfg(zoo["fx"]), device="cpu")))
    path = str(zoo["dir"] / ("%s.model.npz" % direction))
    zoo[src].save_model(path)
    dst.load_model(path)
    a, _ = zoo[src].gather_snapshot()
    b, _ = dst.gather_snapshot()
    assert sorted(a) == sorted(b)
    for k in ("param/pr1/bias", "state/in1/step", "state/in1/ub",
              "param/pt1/slave:wmat", "state/pt1/pairtest:max_diff",
              "param/bn1/wmat", "opt/pr1/bias/m_w"):
        assert k in a, k
    assert not any(k.startswith("state/bn1/") for k in a)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


# ------------------------------------------------ registry and builders

def _type_strings():
    base = sorted(jax_layers._FACTORY) + list(jax_layers._VESTIGIAL)
    pairs = ["pairtest-%s-%s" % ab for ab in (
        ("conv", "torch"), ("fullc", "torch"), ("xelu", "insanity"),
        ("batch_norm", "pallas_batch_norm"), ("maxout", "relu"),
        ("relu", "nope"))]
    return base + pairs + ["nope", "pairtest-", "pairtest-conv", "share"]


@pytest.mark.parametrize("type_str", _type_strings())
def test_registry_matches_reference(type_str):
    """``known_layer_type`` agrees with the reference's on every type
    string, and ``create_layer`` builds the same class (by name) or
    raises the reference's ValueError with the same message; no type
    raises NotPortedError."""
    from cxxnet_tpu_torch.utils.config import NotPortedError
    assert port_layers.known_layer_type(type_str) == \
        jax_layers.known_layer_type(type_str)
    cfg = [("nhidden", "4"), ("nchannel", "4"), ("kernel_size", "1")]
    try:
        want = type(jax_layers.create_layer(type_str, cfg)).__name__
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_layers.create_layer(type_str, cfg)
        assert not isinstance(got.value, NotPortedError)
        assert str(got.value) == str(e)
        return
    layer = port_layers.create_layer(type_str, cfg)
    assert type(layer).__name__ == want


def test_registry_covers_the_reference():
    assert sorted(port_layers._FACTORY) == sorted(jax_layers._FACTORY)
    assert port_layers._VESTIGIAL == jax_layers._VESTIGIAL
    assert not hasattr(port_layers, "_NOT_PORTED")


@pytest.mark.parametrize("name", sorted(jax_models.__all__))
def test_model_text_matches_reference(name):
    """Every zoo builder's text equals the reference's, at its defaults
    and at other arguments."""
    assert getattr(port_models, name)() == getattr(jax_models, name)()
    kw = {"alexnet": {"nclass": 10, "batch_size": 4, "image_size": 99,
                      "lr": 0.5},
          "mnist_mlp": {"nhidden": 7, "nclass": 3, "batch_size": 5},
          "mnist_conv": {"nclass": 3, "batch_size": 5},
          "kaggle_bowl": {"nclass": 7, "batch_size": 3}}.get(name)
    if kw:
        assert getattr(port_models, name)(**kw) == \
            getattr(jax_models, name)(**kw)
