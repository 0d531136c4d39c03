"""The port's mixed-precision training against the JAX package.

The repo's own training set, bench.py's: ``dtype = grad_dtype =
momentum_dtype = bfloat16`` (``example/ImageNet/Inception-BN.conf``
sets ``dtype = bfloat16``). Numpy-seeded inputs go through both
packages; the reference runs its Pallas kernels in interpret mode, the
port its kernels' plain versions (the bf16 CUDA kernels are held to
those on the card by ``chip_smoke.py``).

**Kernels.** bn_apply (forward and dx), relu_max_pool (forward and
backward) on bf16: bit for bit. The f32 sums (bn_apply's dscale and
dshift, matmul's output) within 1e-6 of the sum of their terms'
magnitudes; matmul's dx and dw, cast to bf16, within one bf16 ulp more.

**Nets.** Inception-BN-tiny (``pallas_fullc`` fc1, ``bn_pallas``,
``bn_fuse_relu``) at the bench set and kaiming-tiny (``fused_pools``,
``pallas_pool = 1``, dropout masks injected) at ``dtype =
momentum_dtype = bfloat16``, three steps from one reference snapshot.
The reference's step is compiled with XLA's
``xla_allow_excess_precision`` off, so that it rounds to bf16 after
every op, as eager PyTorch does. (With it on, the default, XLA may keep
f32 inside a fusion: its own jitted run then lies 4.4e-3 (whole state,
relative) from its per-op run after three Inception-BN-tiny steps, and
its first loss differs in the fourth digit.) Two comparisons:

- step for step: before each step the port loads the reference's
  state, takes the same step, and is compared with the reference's
  next state. Measured on the CPU, one thread: Inception-BN-tiny's
  losses equal to nine digits, the whole state within 9.3e-6, max |Δ|
  1.2e-4, the worst single array 3.4e-3 (a 16-channel BN bias's
  momentum, where one bf16 rounding of one gradient element, from
  convolution backwards that sum in another order, is 1/16 of the
  array). Held:
  losses rtol 1e-6, whole state 1e-4, every array 2e-2, max |Δ| 1e-3.
  kaiming-tiny: losses within 3.5e-5 (its bf16 products round
  differently now and then), whole state 5.7e-6, non-bias arrays 8.0e-3
  and bias arrays 3.3e-2 (``param/conv1/bias``). Both packages sum a
  bf16 bias gradient in bf16 in XLA:CPU's order (``kernels.bias_add``,
  ``test_torch_port_bf16_grads.py``; before the port did, in f32, the
  bias arrays lay 7.4e-2 away); the stem's cotangent arrives through
  convolution backwards that sum in another order, and a bf16 sum over
  windows of 4x32x32 terms turns a last-bit change of one term into a
  step of the running sum's ulp. Held: losses rtol 1e-4, whole state
  1e-4, non-bias and bias arrays 5e-2.
- free running: three steps each from the one snapshot. bf16 rounding
  differences compound through the steps (the reference's own jit and
  per-op runs diverge as far): measured whole state 3.2e-3 and losses
  4.0e-3 (Inception-BN-tiny), 1.6e-4 and 2.9e-5 (kaiming-tiny). Held:
  whole state and losses within 2e-2 and 1e-2 (Inception-BN-tiny), 2e-3
  and 1e-3 (kaiming-tiny).

Snapshots with bf16 momentum cross both ways; the resuming run's
``momentum_dtype`` decides the buffer's dtype, as in the reference.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import pallas_kernels as jax_pk
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layers import common, kernels
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config
# the tiny nets of the float32 slices' tests, and the reference's
# dropout draw those inject
from test_torch_port_kaiming import _cfg as _kaiming_tiny_cfg
from test_torch_port_kaiming import jax_uniform
from test_torch_port_train import _cfg as _inception_tiny_cfg

BENCH = [("dtype", "bfloat16"), ("grad_dtype", "bfloat16"),
         ("momentum_dtype", "bfloat16")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops on one thread: at these sizes more threads
    only contend with the JAX runtime's own (and one thread keeps
    oneDNN's summation order fixed)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bf16(a: np.ndarray):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


# -------------------------------------------------------------- kernels


@pytest.mark.parametrize("shape", [(2, 4, 4, 64), (3, 5, 7, 6), (6, 24)],
                         ids=["nhwc", "ragged_c", "mat"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_bn_apply_bf16_plain_matches_pallas(shape, relu):
    """Forward and dx bit for bit; dscale, dshift (f32 sums of bf16
    terms) within 1e-6 of the sum of the terms' magnitudes."""
    kernels.reset_launch_counts()
    rng = np.random.RandomState(sum(shape) + relu)
    c = shape[-1]
    x, xj = _bf16(rng.randn(*shape))
    dy, dyj = _bf16(rng.randn(*shape))
    s = (rng.rand(c) + 0.5).astype(np.float32)
    t = rng.randn(c).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, b, d: jax_pk.bn_apply(a, b, d, relu), xj,
                      jnp.asarray(s), jnp.asarray(t))
    jdx, jds, jdt = vjp(dyj)
    y = kernels.bn_apply_fwd(x, torch.from_numpy(s), torch.from_numpy(t),
                             relu)
    dx, ds, dt = kernels.bn_apply_bwd(x, y, dy, torch.from_numpy(s), relu)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert ds.dtype == dt.dtype == torch.float32
    np.testing.assert_array_equal(_f32(y), _f32(jy))
    np.testing.assert_array_equal(_f32(dx), _f32(jdx))
    axes = tuple(range(len(shape) - 1))
    dym = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    mag_s = (dym * x).float().abs().sum(axes).numpy()
    mag_t = dym.float().abs().sum(axes).numpy()
    assert np.all(np.abs(_f32(ds) - _f32(jds)) <= 1e-6 * mag_s)
    assert np.all(np.abs(_f32(dt) - _f32(jdt)) <= 1e-6 * mag_t)
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_bn_apply_bf16_dx_turns_negative_zero_positive():
    """The reference adds a zero shift to dx (``pallas_kernels.py:
    310-319``): a -0 product comes out +0, in the plain version too."""
    x = torch.tensor([[1.0, -2.0]], dtype=torch.bfloat16)
    dy = torch.tensor([[-0.0, 0.0]], dtype=torch.bfloat16)
    s = torch.tensor([3.0, -1.0])
    dx, _, _ = kernels.bn_apply_bwd(x, None, dy, s, False)
    assert not torch.signbit(dx).any()


@pytest.mark.parametrize("dtypes", [("bf16", "bf16"), ("f32", "bf16"),
                                    ("bf16", "f32")],
                         ids=["bf16_bf16", "f32_bf16", "bf16_f32"])
def test_matmul_bf16_plain_and_vjp_match_pallas(dtypes):
    """x . w with each operand's dtype as on the path (the forward
    bf16 . bf16; the VJP's dy . w^T is f32 . bf16 and x^T . dy bf16 .
    f32): the f32 output within 1e-6 of sum |a*b|; dx, dw cast to their
    operand's dtype within that plus one bf16 ulp."""
    kernels.reset_launch_counts()
    m, k, n = 5, 37, 9
    rng = np.random.RandomState(len(dtypes[0]) + 3 * len(dtypes[1]))
    ops = []
    for nm, shape in zip(dtypes, ((m, k), (k, n))):
        a = rng.randn(*shape)
        ops.append(_bf16(a) if nm == "bf16" else
                   (torch.from_numpy(a.astype(np.float32)),
                    jnp.asarray(a.astype(np.float32))))
    (xt, xj), (wt, wj) = ops
    dy = rng.randn(m, n).astype(np.float32)
    jy, vjp = jax.vjp(jax_pk.matmul, xj, wj)
    jdx, jdw = vjp(jnp.asarray(dy))
    xl, wl = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    y = kernels.matmul(xl, wl)
    dx, dw = torch.autograd.grad(y, (xl, wl), torch.from_numpy(dy))
    assert y.dtype == torch.float32
    assert dx.dtype == xt.dtype and dw.dtype == wt.dtype
    xf, wf = xt.double().numpy(), wt.double().numpy()
    for got, ref, mag, bf in (
            (y, jy, np.abs(xf) @ np.abs(wf), False),
            (dx, jdx, np.abs(dy) @ np.abs(wf).T, xt.dtype == torch.bfloat16),
            (dw, jdw, np.abs(xf).T @ np.abs(dy), wt.dtype == torch.bfloat16)):
        ref = _f32(ref)
        tol = 1e-6 * mag + (_bf16_ulp(ref) if bf else 0.0)
        assert np.all(np.abs(_f32(got) - ref) <= tol)
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("shape,k", [((2, 9, 9, 8), 3), ((1, 7, 8, 3), 2),
                                     ((2, 13, 13, 4), 6)],
                         ids=["k3", "k2_ragged", "k6_spp"])
def test_relu_max_pool_bf16_plain_matches_pallas(shape, k):
    """Inputs on a 0.5 grid (tied maxima, every one credited) and a
    bf16 cotangent: forward and dx bit for bit (the same f32 compares,
    the same f32 sums in (di, dj) order, one rounding to bf16)."""
    rng = np.random.RandomState(sum(shape) + k)
    x, xj = _bf16(np.round(2 * rng.randn(*shape)) / 2)
    oshape = (shape[0], shape[1] - k + 1, shape[2] - k + 1, shape[3])
    dy, dyj = _bf16(rng.randn(*oshape))
    jy, vjp = jax.vjp(lambda a: jax_pk.relu_max_pool(a, k), xj)
    (jdx,) = vjp(dyj)
    xl = x.clone().requires_grad_(True)
    y = kernels.relu_max_pool(xl, k)
    (dx,) = torch.autograd.grad(y, (xl,), dy)
    assert y.dtype == dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(y), _f32(jy))
    np.testing.assert_array_equal(_f32(dx), _f32(jdx))


def test_softmax_loss_on_bf16_logits_matches_reference():
    """A plain fullc under ``dtype = bfloat16`` hands the loss bf16
    logits: both packages take the loss in f32 (rtol 1e-6) and hand back
    a bf16 gradient, the f32 gradient rounded once (equal here)."""
    from cxxnet_tpu.layers import create_layer as jax_create
    from cxxnet_tpu_torch.layers import create_layer
    rng = np.random.RandomState(9)
    z, zj = _bf16(rng.randn(6, 10) * 3)
    label = rng.randint(0, 10, (6, 1)).astype(np.float32)
    jl, pl = jax_create("softmax", []), create_layer("softmax", [])
    jl.batch_size = pl.batch_size = 6
    jv, jg = jax.value_and_grad(
        lambda a: jl.loss_value(a, jnp.asarray(label), None))(zj)
    zl = z.clone().requires_grad_(True)
    pv = pl.loss_value(zl, torch.from_numpy(label), None)
    (pg,) = torch.autograd.grad(pv, [zl])
    assert pv.dtype == torch.float32 and pg.dtype == torch.bfloat16
    assert str(jg.dtype) == "bfloat16"
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-6)
    np.testing.assert_array_equal(_f32(pg), _f32(jg))


# ------------------------------------------------------------------ nets


class _PerOpRounding:
    """A reference trainer's jitted step, compiled with XLA's
    ``xla_allow_excess_precision`` off: every bf16 op rounds, as the
    port's eager ops do. One executable per argument signature."""

    def __init__(self, jitted):
        self.jitted, self.compiled = jitted, {}

    def __call__(self, *args, **static):
        leaves = jax.tree_util.tree_leaves(args)
        key = (str(jax.tree_util.tree_structure(args)),
               tuple((np.shape(a), str(getattr(a, "dtype", type(a))))
                     for a in leaves), tuple(sorted(static.items())))
        if key not in self.compiled:
            self.compiled[key] = self.jitted.lower(*args, **static).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return self.compiled[key](*args)


def _incep_cfg():
    """Inception-BN-tiny as ``tests/test_torch_port_train.py`` builds it
    (``pallas_fullc`` fc1, ``bn_pallas``, ``bn_fuse_relu``), at the
    bench set."""
    return _inception_tiny_cfg(BENCH)


def _kaiming_cfg():
    """kaiming-tiny as ``tests/test_torch_port_kaiming.py`` builds it, at
    ``dtype = momentum_dtype = bfloat16`` (bench.py's kaiming entry)."""
    return _kaiming_tiny_cfg([("dtype", "bfloat16"),
                              ("momentum_dtype", "bfloat16")])


NETS = {
    # cfg, image size, classes, padded tail rows, tolerances
    "inception": (_incep_cfg, 16, 8, 0,
                  {"loss": 1e-6, "whole": 1e-4, "array": 2e-2,
                   "bias": 2e-2, "abs": 1e-3, "free_whole": 2e-2,
                   "free_loss": 1e-2}),
    "kaiming": (_kaiming_cfg, 208, 10, 1,
                {"loss": 1e-4, "whole": 1e-4, "array": 5e-2, "bias": 5e-2,
                 "abs": 1e-3, "free_whole": 2e-3, "free_loss": 1e-3}),
}


def _state(trainer):
    return {k: np.asarray(v, np.float64)
            for k, v in trainer.gather_snapshot()[0].items()}


def _whole_rel(a, b):
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    return (num / sum(float(np.sum(b[k] ** 2)) for k in b)) ** 0.5


def _conf_cfg():
    """Inception-BN-tiny at example/ImageNet/Inception-BN.conf's own
    precision: ``dtype = bfloat16`` alone (float32 gradients and
    momentum), fc1 a plain fullc, whose bias gradient sums in bf16."""
    return [(n, "fullc:fc1" if v == "pallas_fullc:fc1" else v)
            for n, v in _inception_tiny_cfg([("dtype", "bfloat16")])]


CONF_NET = (_conf_cfg, 16, 8, 0, NETS["inception"][4])


@pytest.fixture(scope="module", params=sorted(NETS))
def run(request, tmp_path_factory):
    """The reference (per-op rounding) and the port from one reference
    snapshot, three steps: the port free running, and the port re-loaded
    from the reference's state before each step."""
    return _run_net(request.param, NETS[request.param], tmp_path_factory)


def _run_net(name, net, tmp_path_factory):
    make_cfg, size, ncls, pad, tol = net
    d = tmp_path_factory.mktemp("port_bf16_" + name)
    jt = JaxTrainer(make_cfg())
    jt.init_model()
    s0 = str(d / "s0.model.npz")
    jt.save_model(s0)
    jt._train_step = _PerOpRounding(jt._train_step)
    free = NetTrainer(make_cfg(), device="cpu")
    free.load_model(s0)
    rng = np.random.RandomState(1)
    steps = []
    masks = pytest.MonkeyPatch.context() if name == "kaiming" \
        else contextlib.nullcontext()
    with masks as mp:
        if mp is not None:
            mp.setattr(common, "dropout_uniform", jax_uniform)
        for i in range(3):
            x = (rng.randn(4, size, size, 3)
                 * rng.uniform(0.5, 2.0, (4, 1, 1, 3))).astype(np.float32)
            y = rng.randint(0, ncls, (4, 1)).astype(np.float32)
            pre = str(d / ("pre%d.model.npz" % i))
            jt.save_model(pre)
            synced = NetTrainer(make_cfg(), device="cpu")
            synced.load_model(pre)
            jt.update(JaxBatch(data=x, label=y, num_batch_padd=pad))
            synced.update(DataBatch(x, y, num_batch_padd=pad))
            free.update(DataBatch(x, y, num_batch_padd=pad))
            steps.append({"ref_loss": float(jt._last_loss),
                          "synced_loss": synced.last_loss,
                          "free_loss": free.last_loss,
                          "ref": _state(jt), "synced": _state(synced)})
    return {"name": name, "tol": tol, "steps": steps, "jax": jt,
            "free": free, "dir": d}


def test_bf16_step_for_step_matches_reference(run):
    _check_step_for_step(run)


def _check_step_for_step(run):
    tol = run["tol"]
    for i, st in enumerate(run["steps"]):
        np.testing.assert_allclose(st["synced_loss"], st["ref_loss"],
                                   rtol=tol["loss"], err_msg="step %d" % i)
        ref, got = st["ref"], st["synced"]
        assert set(ref) == set(got)
        assert _whole_rel(got, ref) <= tol["whole"], i
        for k in ref:
            diff = got[k] - ref[k]
            lim = tol["bias"] if "/bias" in k else tol["array"]
            assert np.linalg.norm(diff) <= lim * np.linalg.norm(ref[k]) \
                + 1e-12, (i, k)
            assert np.abs(diff).max() <= tol["abs"], (i, k)
    # the losses moved: the comparison follows real updates
    losses = [st["ref_loss"] for st in run["steps"]]
    assert len(set(losses)) == 3


def test_bf16_three_free_steps_stay_near_reference(run):
    _check_free(run)


def _check_free(run):
    tol = run["tol"]
    np.testing.assert_allclose([s["free_loss"] for s in run["steps"]],
                               [s["ref_loss"] for s in run["steps"]],
                               rtol=tol["free_loss"])
    got, ref = _state(run["free"]), run["steps"][-1]["ref"]
    assert _whole_rel(got, ref) <= tol["free_whole"]


def test_conf_precision_matches_reference(tmp_path_factory):
    """Inception-BN-tiny at Inception-BN.conf's precision (``dtype =
    bfloat16`` alone: float32 gradients and momentum, a plain fullc fc1
    whose bias gradient sums in bf16), step for step and free running,
    within the bench set's tolerances (measured on the CPU: losses
    equal, whole state 5.0e-5, worst array 7.2e-3, max |Δ| 1.2e-4; free
    running 2.5e-3)."""
    run = _run_net("conf", CONF_NET, tmp_path_factory)
    _check_step_for_step(run)
    _check_free(run)
    t = run["free"]
    ms = [st["m_w"] for tags in t.opt_state.values()
          for st in tags.values() if st]
    assert ms and all(m.dtype == torch.float32 for m in ms)


def test_bf16_training_keeps_masters_f32_and_momentum_bf16(run):
    """Masters and BN state stay float32; the sgd momentum is stored in
    bf16 (``momentum_dtype``) and snapshots carry it as float32."""
    t = run["free"]
    assert all(v.dtype == torch.float32 for sub in t.params.values()
               for v in sub.values())
    ms = [st["m_w"] for tags in t.opt_state.values()
          for st in tags.values() if st]
    assert ms and all(m.dtype == torch.bfloat16 for m in ms)
    arrays, _ = t.gather_snapshot()
    assert all(v.dtype == np.float32 for k, v in arrays.items()
               if k.startswith("opt/"))
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("resume", ["bfloat16", "float32"])
def test_bf16_momentum_snapshots_cross_both_ways(run, resume):
    """The reference's bf16-momentum snapshot resumes in the port, and
    the port's in the reference; the resuming run's momentum_dtype
    decides the buffer's dtype, the values cross exactly."""
    d = run["dir"]
    cfg = [(n, v) for n, v in NETS[run["name"]][0]()
           if n != "momentum_dtype"] + [("momentum_dtype", resume)]
    want_t = torch.bfloat16 if resume == "bfloat16" else torch.float32
    want_j = jnp.bfloat16 if resume == "bfloat16" else jnp.float32
    jpath = str(d / ("jax_%s.model.npz" % resume))
    run["jax"].save_model(jpath)
    port = NetTrainer(cfg, device="cpu")
    port.load_model(jpath)
    src = run["jax"].opt_state
    for lk, tags in port.opt_state.items():
        for tag, st in tags.items():
            if not st:
                continue
            assert st["m_w"].dtype == want_t
            np.testing.assert_array_equal(
                st["m_w"].float().numpy(),
                np.asarray(src[lk][tag]["m_w"], np.float32))
    ppath = str(d / ("port_%s.model.npz" % resume))
    run["free"].save_model(ppath)
    back = JaxTrainer(cfg)
    back.load_model(ppath)
    for lk, tags in run["free"].opt_state.items():
        for tag, st in tags.items():
            if not st:
                continue
            m = back.opt_state[lk][tag]["m_w"]
            assert m.dtype == want_j
            np.testing.assert_array_equal(np.asarray(m, np.float32),
                                          st["m_w"].float().numpy())


# ------------------------------------------------------ update_period

_MLP = """netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 32
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,24
eta = 0.1
momentum = 0.9
"""


def test_update_period_with_bf16_grads_matches_big_batch():
    """Port of the reference's ``tests/test_trainer.py:446``: gradient
    accumulation stays f32 under ``grad_dtype = bfloat16``, so two
    50-row windows track one 100-row step within bf16 rounding of the
    per-window gradients (atol 5e-4, the reference's)."""
    rng = np.random.RandomState(5)
    x = rng.rand(200, 24).astype(np.float32)
    y = rng.randint(0, 4, (200, 1)).astype(np.float32)
    bf16 = [("dtype", "bfloat16"), ("grad_dtype", "bfloat16")]
    ta = NetTrainer(parse_config(_MLP) + bf16 + [
        ("batch_size", "50"), ("update_period", "2")], device="cpu")
    tb = NetTrainer(parse_config(_MLP) + bf16 + [("batch_size", "100")],
                    device="cpu")
    ta.init_model()
    tb.init_model()
    for lk, sub in tb.params.items():
        for tag, v in sub.items():
            assert torch.equal(v, ta.params[lk][tag])
    for i in range(4):
        ta.update(DataBatch(x[50 * i:50 * i + 50], y[50 * i:50 * i + 50]))
    for i in range(2):
        tb.update(DataBatch(x[100 * i:100 * i + 100],
                            y[100 * i:100 * i + 100]))
    assert ta.update_counter == tb.update_counter == 2
    wa, wb = ta.params["fc1"]["wmat"], tb.params["fc1"]["wmat"]
    assert wa.dtype == torch.float32
    np.testing.assert_allclose(wa.numpy(), wb.numpy(), rtol=0, atol=5e-4)
    assert not torch.equal(wa, wb)      # bf16 gradients, not f32 ones


def test_grad_dtype_bf16_needs_dtype_bf16():
    """The reference's ValueError (``nnet/trainer.py:453-457``)."""
    cfg = parse_config(_MLP) + [("batch_size", "8"),
                                ("grad_dtype", "bfloat16")]
    with pytest.raises(ValueError, match="requires dtype=bfloat16"):
        NetTrainer(cfg, device="cpu").init_model()
    with pytest.raises(ValueError, match="requires dtype=bfloat16"):
        JaxTrainer(cfg).init_model()
