"""The port's pool_concat slice against the JAX package.

``pool_concat_pallas = 1`` fuses an Inception tower's ``ch_concat``
with the stride-1 SAME pool that is one of its branches: the pool layer
passes its input through and the concat reduces the window on the way
(``cxxnet_tpu/nnet/net.py:175-225``, ``layers/common.py:391-399``,
``layers/pallas_kernels.py:412-540``). The reference runs its Pallas
kernel in interpret mode, the port the kernel's plain version.

- The plain version against the reference's ``pool_concat``, forward
  and ``jax.vjp``: both modes, every branch position, k = 3 and 5,
  float32 and bfloat16, inputs on a 0.5 grid (tied maxima, exact
  zeros) and a NaN in the max cases: the same bits. bf16 avg rounds
  every add; the reference is compiled with ``xla_allow_excess_precision``
  off, as ``test_torch_port_bf16.py`` compiles its steps. (With the flag
  on its interpret-mode result was the same bits on these inputs and on
  N(0, 9) inputs: 0 of 576 entries differed.)
- The planner on the full-width tower of ``chip_smoke.py`` (shapes
  only, no forward): both packages fuse t3a and t4a at float32 and also
  t3b at ``dtype = bfloat16`` (the 6 MiB gate at itemsize 2), never the
  stride-2 t3c. The two config texts are the same string.
- The reference's gate cases (``tests/test_pallas.py:346-437``) rerun
  against the port.
- A tiny tower (an avg module, a stride-2 module, a max module) trains
  three steps from one reference snapshot, the port re-loaded from the
  reference's state before each step, at float32 and at the bench set
  (``dtype = grad_dtype = momentum_dtype = bfloat16``), its snapshot
  loads in the reference, and it is served on the CPU against the
  reference's eval rows. Tolerances at the fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cxxnet_tpu.graph import NetGraph as JaxNetGraph
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import pallas_kernels as jax_pk
from cxxnet_tpu.models import inception as jax_inception
from cxxnet_tpu.nnet.net import FuncNet as JaxFuncNet
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import parse_config as jax_parse
from cxxnet_tpu_torch.graph import NetGraph
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.models import inception as port_inception
from cxxnet_tpu_torch.nnet.net import FuncNet
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import ServeSession
from cxxnet_tpu_torch.utils.config import parse_config
from test_torch_port_bf16 import _PerOpRounding, _state, _whole_rel

BENCH = [("dtype", "bfloat16"), ("grad_dtype", "bfloat16"),
         ("momentum_dtype", "bfloat16")]
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops on one thread: at these sizes more threads
    only contend with the JAX runtime's own."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f32(t):
    return t.detach().float().numpy()


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))


# ------------------------------------------------------------- kernel

CASES = [(mode, dt, pos, k) for mode in ("max", "avg")
         for dt in ("float32", "bfloat16")
         for pos, k in ((0, 3), (1, 5), (2, 3))]


@pytest.mark.parametrize("mode,dtype,pos,k", CASES,
                         ids=["%s-%s-pos%d-k%d" % c for c in CASES])
def test_pool_concat_plain_matches_pallas(mode, dtype, pos, k):
    rng = np.random.RandomState(pos + 7 * k)
    widths = (5, 3, 4)                 # ragged, not multiples of 8
    xs = []
    for i, c in enumerate(widths):
        x = (np.round(2 * rng.randn(2, 7, 6, c)) / 2).astype(np.float32)
        if mode == "max" and i == pos:
            x.reshape(-1)[::37] = np.nan
        xs.append(torch.from_numpy(x).to(getattr(torch, dtype)))
    dy = torch.from_numpy((np.round(4 * rng.randn(2, 7, 6, sum(widths)))
                           / 4).astype(np.float32)).to(getattr(torch, dtype))
    jx = [jnp.asarray(_f32(x)).astype(dtype) for x in xs]
    jdy = jnp.asarray(_f32(dy)).astype(dtype)

    def ref(*bs):
        out, vjp = jax.vjp(lambda *b: jax_pk.pool_concat(b, pos, k, mode),
                           *bs)
        return out, vjp(jdy)

    jout, jgrads = jax.jit(ref).lower(*jx).compile(
        compiler_options=NO_EXCESS)(*jx)
    leaves = [x.clone().requires_grad_(True) for x in xs]
    out = kernels.pool_concat(leaves, pos, k, mode)
    grads = torch.autograd.grad(out, leaves, dy)
    assert out.dtype == xs[0].dtype
    _same_bits(jout, _f32(out))
    for jg, g, x in zip(jgrads, grads, xs):
        assert g.dtype == x.dtype
        _same_bits(jg, _f32(g))
    if mode == "max":
        assert np.isnan(_f32(out)).any()


@pytest.mark.parametrize("k", [3, 5])
def test_pool_concat_bf16_avg_rounds_every_add(k):
    """bf16 avg on N(0, 9) values, where the window sums round: the
    same bits as the reference compiled with excess precision off."""
    rng = np.random.RandomState(k)
    xs = [torch.from_numpy(rng.randn(2, 9, 8, c).astype(np.float32) * 3)
          .to(torch.bfloat16) for c in (5, 4)]
    jx = [jnp.asarray(_f32(x)).astype("bfloat16") for x in xs]
    ref = jax.jit(lambda *b: jax_pk.pool_concat(b, 1, k, "avg")).lower(
        *jx).compile(compiler_options=NO_EXCESS)(*jx)
    got = kernels.pool_concat(xs, 1, k, "avg")
    _same_bits(ref, _f32(got))
    # the sums did round: a float32 sum would differ
    plain32 = kernels.pool_concat([x.float() for x in xs], 1, k, "avg")
    assert not torch.equal(plain32.to(torch.bfloat16), got)


def test_pool_concat_backward_reads_strided_dy():
    """A permuted cotangent is read through its strides: the same
    gradient as from a dense one."""
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy(rng.randn(2, 5, 5, c).astype(np.float32))
          for c in (3, 4)]
    out = kernels.pool_concat_fwd(xs, 1, 3, "max")
    dy = torch.from_numpy(rng.randn(2, 5, 5, 7).astype(np.float32))
    dyv = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    np.testing.assert_array_equal(
        kernels.pool_concat_bwd(xs[1], out, dy, 3, 3, "max").numpy(),
        kernels.pool_concat_bwd(xs[1], out, dyv, 3, 3, "max").numpy())


# ------------------------------------------------------------ planner


def _fused_names(graph, fused):
    names = {v: k for k, v in graph.node_name_map.items()}
    return sorted(names[graph.layers[li].nindex_out[0]] for li in fused)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_planner_matches_reference(dtype):
    text = chip_smoke.tower_text(128)
    assert text == chip_smoke.tower_text(128, helpers=jax_inception)
    extra = [("pool_concat_pallas", "1")] + (
        [("dtype", "bfloat16")] if dtype == "bfloat16" else [])
    pg, jg = NetGraph(), JaxNetGraph()
    pg.configure(parse_config(text) + extra)
    jg.configure(jax_parse(text) + extra)
    pn, jn = FuncNet(pg, 128), JaxFuncNet(jg, 128)
    assert pn.fused_concats == jn._pool_concat
    assert pn._pool_passthrough == jn._pool_passthrough
    assert _fused_names(pg, pn.fused_concats) == \
        sorted(chip_smoke.TOWER_FUSED[dtype])
    assert sum(info.type == "conv" for info in pg.layers) == 26
    assert sum(info.type == "batch_norm" for info in pg.layers) == 26


GATE_BASE = """
netconfig=start
layer[0->1] = conv:c1
  nchannel = 8
  kernel_size = 3
  pad = 1
layer[1->2] = relu
layer[2->3,4] = split
layer[3->5] = conv:b1
  nchannel = 8
  kernel_size = 1
layer[4->6] = avg_pooling
  kernel_size = 3
  stride = %s
  pad = %s
layer[5,6->7] = ch_concat
layer[7->8] = flatten
layer[8->9] = fullc:fc
  nhidden = 4
layer[9->9] = softmax
netconfig=end
input_shape = 3,8,8
batch_size = 8
eta = 0.05
pool_concat_pallas = 1
"""
SAME = GATE_BASE % ("1", "1")
GATES = {
    "fuses": (SAME, (1, 3, "avg")),
    "knob_off": (SAME.replace("pool_concat_pallas = 1",
                              "pool_concat_pallas = 0"), None),
    # a second reader of the pool's output: the pass-through would
    # change what it sees
    "second_consumer": (SAME.replace("layer[7->8] = flatten",
                                     "layer[7,6->7b] = ch_concat\n"
                                     "layer[7b->8] = flatten"), None),
    # a stride-2 reduction module (k = 2, so floor and ceil sizes agree)
    "reduction": (SAME.replace("  nchannel = 8\n  kernel_size = 1",
                               "  nchannel = 8\n  kernel_size = 2\n"
                               "  stride = 2")
                  .replace("  kernel_size = 3\n  stride = 1\n  pad = 1",
                           "  kernel_size = 2\n  stride = 2"), None),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_pool_concat_gates_match_reference(case, tmp_path):
    text, want = GATES[case]
    jt = JaxTrainer(jax_parse(text))
    jt.init_model()
    pt = NetTrainer(parse_config(text), device="cpu")
    pt.init_model()
    assert pt.net.fused_concats == jt.net._pool_concat
    assert list(pt.net.fused_concats.values()) == ([want] if want else [])
    assert len(pt.net._pool_passthrough) == (1 if want else 0)


def test_pool_concat_gate_refusals_raise_as_in_reference():
    """A VALID pool changes the branch's size, so the concat refuses
    the net in both packages; under channel_pad, which the reference's
    planner defers to, no concat fuses in either package."""
    valid = parse_config(GATE_BASE % ("1", "0"))
    with pytest.raises(Exception):
        JaxTrainer(jax_parse(GATE_BASE % ("1", "0"))).init_model()
    with pytest.raises(ValueError, match="concat"):
        NetTrainer(valid, device="cpu").init_model()
    padded = NetTrainer(parse_config(SAME) + [("channel_pad", "128")],
                        device="cpu")
    padded.init_model()
    from cxxnet_tpu.graph import NetGraph as JaxGraph
    from cxxnet_tpu.nnet.net import FuncNet as JaxNet
    jg = JaxGraph()
    jg.configure(jax_parse(SAME) + [("channel_pad", "128")])
    assert padded.net.fused_concats == JaxNet(jg, jg.batch_size)._pool_concat \
        == {}


def test_pool_concat_applicable_matches_reference():
    for h, w, c, k, isz in [(8, 8, 32, 3, 4), (28, 28, 1024, 3, 2),
                            (112, 112, 1024, 3, 4), (8, 8, 32, 2, 4),
                            (8, 8, 32, 1, 4), (28, 28, 416, 3, 4),
                            (28, 28, 672, 3, 4), (28, 28, 672, 3, 2),
                            (14, 14, 1376, 3, 4), (14, 14, 1376, 5, 4)]:
        assert kernels.pool_concat_applicable(h, w, c, k, isz) == \
            jax_pk.pool_concat_applicable(h, w, c, k, isz), (h, w, c, k, isz)


# ----------------------------------------------------------- tiny tower

BATCH, IMAGE, NCLASS = 4, 16, 8
# (name, 1x1, 3x3r, 3x3, d3r, d3, pool, proj, stride): an avg module, a
# stride-2 reduction module, a max module
TINY_MODULES = (("ta", 8, 4, 8, 4, 8, "avg", 0, 1),
                ("tr", 0, 8, 8, 4, 8, "max", 0, 2),
                ("tb", 8, 4, 8, 4, 8, "max", 0, 1))


def _tiny_text(helpers):
    L = ["netconfig=start"]
    helpers._conv_bn_relu(L, "0", "c1", "conv1", 8, 3, 1, 1)
    top = "c1"
    for (nm, n1, n3r, n3, nd3r, nd3, pool, np_, st) in TINY_MODULES:
        top = helpers._inception(L, top, nm, n1, n3r, n3, nd3r, nd3, pool,
                                 np_, st)
    L += ["layer[%s->gap] = avg_pooling" % top, "  kernel_size = 8",
          "  stride = 1", "layer[gap->flat] = flatten",
          "layer[flat->fc] = pallas_fullc:fc1", "  nhidden = %d" % NCLASS,
          "  init_sigma = 0.01", "layer[fc->fc] = softmax", "netconfig=end",
          "input_shape = 3,%d,%d" % (IMAGE, IMAGE),
          "batch_size = %d" % BATCH, "momentum = 0.9", "eta = 0.05",
          "random_type = xavier", "metric = error"]
    return "\n".join(L) + "\n"


TRAIN_KNOBS = [("bn_pallas", "1"), ("bn_fuse_relu", "1"),
               ("pool_concat_pallas", "1"), ("save_optimizer", "1"),
               ("seed", "5")]
SERVE_KNOBS = [("bn_fold_eval", "1"), ("bn_fuse_relu", "1"),
               ("conv_pallas_epilogue", "1"), ("pool_concat_pallas", "1")]
TOWERS = {
    # the same f32 arithmetic, sums (convolutions, BN moments, channel
    # sums) in another order: losses rtol 1e-5, arrays rtol 1e-4 / atol
    # 1e-5, as tests/test_torch_port_train.py holds Inception-BN-tiny
    # (measured: losses 2.0e-7, arrays 3.4e-6 relative, 1.7e-7 absolute)
    "float32": ([], {"loss": 1e-5, "rtol": 1e-4, "atol": 1e-5}),
    # bf16 roundings of sums taken in another order (convolution
    # backwards) now and then differ by a bf16 step; as
    # tests/test_torch_port_bf16.py holds Inception-BN-tiny (measured:
    # losses 8.7e-8, whole state 6.7e-5, worst array 8.0e-3, max |diff|
    # 1.5e-4)
    "bench": (BENCH, {"loss": 1e-6, "whole": 1e-4, "array": 2e-2,
                      "abs": 1e-3}),
}


@pytest.fixture(scope="module", params=sorted(TOWERS))
def tower(request, tmp_path_factory):
    """Both packages' tiny towers: fused sets, and three steps from one
    reference snapshot with the port re-loaded from the reference's
    state before each step (the reference's bf16 step compiled with
    excess precision off)."""
    extra, tol = TOWERS[request.param]
    text = _tiny_text(port_inception)
    assert text == _tiny_text(jax_inception)
    pcfg, jcfg = parse_config(text) + TRAIN_KNOBS + extra, \
        jax_parse(text) + TRAIN_KNOBS + extra
    d = tmp_path_factory.mktemp("port_tower_" + request.param)
    jt = JaxTrainer(jcfg)
    jt.init_model()
    if extra:
        jt._train_step = _PerOpRounding(jt._train_step)
    rng = np.random.RandomState(2)
    steps = []
    kernels.reset_launch_counts()
    for i in range(3):
        x = (rng.randn(BATCH, IMAGE, IMAGE, 3)
             * rng.uniform(0.5, 2.0, (BATCH, 1, 1, 3))).astype(np.float32)
        y = rng.randint(0, NCLASS, (BATCH, 1)).astype(np.float32)
        pre = str(d / ("pre%d.model.npz" % i))
        jt.save_model(pre)
        pt = NetTrainer(pcfg, device="cpu")
        pt.load_model(pre)
        jt.update(JaxBatch(data=x, label=y))
        pt.update(DataBatch(x, y))
        steps.append({"ref_loss": float(jt._last_loss),
                      "port_loss": pt.last_loss, "ref": _state(jt),
                      "port": _state(pt)})
    return {"name": request.param, "tol": tol, "steps": steps, "jax": jt,
            "port": pt, "dir": d, "launches": kernels.launch_counts()}


def test_tiny_tower_fuses_both_modes(tower):
    fused = tower["port"].net.fused_concats
    assert fused == tower["jax"].net._pool_concat
    assert _fused_names(tower["port"].graph, fused) == ["ta", "tb"]
    assert sorted(m for _, _, m in fused.values()) == ["avg", "max"]
    # on the CPU every wrapper takes its plain version
    assert all(v == 0 for v in tower["launches"].values())


def test_tiny_tower_steps_match_reference(tower):
    tol = tower["tol"]
    for i, st in enumerate(tower["steps"]):
        np.testing.assert_allclose(st["port_loss"], st["ref_loss"],
                                   rtol=tol["loss"], err_msg="step %d" % i)
        ref, got = st["ref"], st["port"]
        assert set(ref) == set(got)
        if "rtol" in tol:
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=tol["rtol"],
                                           atol=tol["atol"], err_msg=k)
            continue
        assert _whole_rel(got, ref) <= tol["whole"], i
        for k in ref:
            diff = got[k] - ref[k]
            assert np.linalg.norm(diff) <= tol["array"] * np.linalg.norm(
                ref[k]) + 1e-12, (i, k)
            assert np.abs(diff).max() <= tol["abs"], (i, k)
    losses = [st["ref_loss"] for st in tower["steps"]]
    assert len(set(losses)) == 3


def test_tiny_tower_port_snapshot_loads_in_reference(tower):
    """The port's tower snapshot (after its third step, optimizer state
    included) loads in the reference with every array the same, and the
    reference plans the same fused concats from it."""
    path = str(tower["dir"] / "port3.model.npz")
    tower["port"].save_model(path)
    jt = JaxTrainer(jax_parse(_tiny_text(jax_inception)) + TRAIN_KNOBS
                    + TOWERS[tower["name"]][0])
    jt.load_model(path)
    assert jt.net._pool_concat == tower["port"].net.fused_concats
    ja, _ = jt.gather_snapshot()
    pa, _ = tower["port"].gather_snapshot()
    assert set(ja) == set(pa) and any(k.startswith("opt/") for k in pa)
    for k in pa:
        np.testing.assert_array_equal(np.asarray(ja[k]), pa[k], err_msg=k)


def test_tiny_tower_serves_the_reference_rows(tower):
    """The reference's state after the three steps served on the CPU
    through ``ServeSession`` with the fold, the epilogue and the fused
    concats: the reference's eval rows within atol 1e-5 / rtol 1e-4 (f32
    sums in another order, as tests/test_torch_port_serve.py holds
    them; 8.2e-6 measured) and the same classes. Under the bench set the
    served activations are bf16 on both sides, where a sum taken in
    another order can round to the neighbouring bf16 value: rows within
    atol 1e-5 / rtol 1e-3 (1.3e-6 measured), classes not held."""
    if tower["name"] != "float32":
        extra = [("dtype", "bfloat16")]
        atol, rtol = 1e-5, 1e-3
    else:
        extra, atol, rtol = [], 1e-5, 1e-4
    text = _tiny_text(port_inception)
    path = str(tower["dir"] / "serve.model.npz")
    tower["jax"].save_model(path)
    jt = JaxTrainer(jax_parse(text) + SERVE_KNOBS + extra)
    jt.load_model(path)
    rng = np.random.RandomState(9)
    x = (rng.randn(BATCH, IMAGE, IMAGE, 3)
         * rng.uniform(0.2, 3.0, (BATCH, 1, 1, 3))).astype(np.float32)
    want = np.asarray(jt.extract_feature(
        JaxBatch(data=x, label=np.zeros((BATCH, 1), np.float32)), "top"))
    sess = ServeSession(parse_config(text) + SERVE_KNOBS + extra
                        + [("serve_buckets", "1,4")], model_path=path,
                        device="cpu")
    try:
        got = np.concatenate([sess.submit(x[i:i + 2]).result(timeout=60)
                              for i in range(0, BATCH, 2)])
        assert len(sess.engine.trainer.net.fused_concats) == 2
    finally:
        sess.close()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    if tower["name"] == "float32":
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
