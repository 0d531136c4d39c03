"""The port's quantized and bfloat16 serving against the JAX package.

Inputs are made from a seed with numpy and go through the reference's
function (its Pallas ``conv_epilogue`` in interpret mode, as
``tests/test_quantize.py`` runs it) and the port's counterpart on the
CPU. Tolerances, each with its reason:

- quantization (``quantize_tensor``), the int8 contractions and the
  calibration weight ranges: exact. The int32 sums are exact in both,
  and quantization is one true division, round half to even, a clamp.
- calibration activation ranges: rtol 2e-6 (17 float32 ulps; 1.2e-6
  seen). The amax is taken over float32 activations that the two
  packages compute with sums in another order (oneDNN here, XLA there),
  up to 15 convolutions deep.
- ``conv_epilogue`` on an int32 accumulator: within one float32 ulp of
  the product ``x * s`` plus one of the output (:func:`_fma_tol`).
  Interpret mode computes ``x * s + t`` as one fused multiply-add (one
  rounding), the port as PyTorch's two eager ops (two roundings), as the
  CUDA kernel does; where ``x * s`` and ``t`` cancel, the product's
  rounding is the larger one. A bfloat16 output may then round to the
  neighbouring bf16 value: one bf16 ulp more.
- the int8 slice: softmax rows atol 1e-4 and the same top-1. The int8
  products are exact, so the rows differ only by the float32 epilogue
  roundings above, and by an int8 step where an activation lies within
  such a rounding of a quantization boundary.
- the bfloat16 slice: softmax rows atol 4e-3 and the same top-1. The
  port runs the reference's bf16 arithmetic op for op (bf16 convs, a
  bf16 epilogue, the avg pool's window sum in bf16), so the rows differ
  only where oneDNN and XLA round a bf16 convolution's sum differently;
  the logits are bf16, whose ulp at |z| in [2, 4) is 2^-6, and one ulp
  in one logit moves a softmax entry near 1/8 by up to 2e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import conv as jax_conv
from cxxnet_tpu.layers.pallas_kernels import conv_epilogue as jax_epilogue
from cxxnet_tpu.nnet import quantize as jq
from cxxnet_tpu.nnet.checkpoint import read_snapshot as jax_read
from cxxnet_tpu.nnet.checkpoint import verify_snapshot
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.serve import ServeSession as JaxSession
from cxxnet_tpu.utils.config import parse_config as jax_parse
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layers import conv as port_conv
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.layers.quant_ops import (conv_int8, dot_int8,
                                               pack_weight)
from cxxnet_tpu_torch.models import inception_bn_tiny
from cxxnet_tpu_torch.nnet import quantize as pq
from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import ServeSession
from cxxnet_tpu_torch.serve.engine import InferenceEngine
from cxxnet_tpu_torch.utils.config import NotPortedError, parse_config

KNOBS = [("bn_fold_eval", "1"), ("bn_fuse_relu", "1"),
         ("conv_pallas_epilogue", "1")]
BATCH, IMAGE = 8, 32
INT8_ATOL, BF16_ATOL = 1e-4, 4e-3
GATE_EPS = 0.05


def _fma_tol(prod, out):
    """What one fused multiply-add and two separate roundings of
    ``prod + t`` may differ by: one float32 ulp of each."""
    return np.spacing(np.abs(prod).astype(np.float32)) \
        + np.spacing(np.abs(out).astype(np.float32))


def _cfg(extra=()):
    return parse_config(inception_bn_tiny(batch_size=BATCH,
                                          image_size=IMAGE)) \
        + KNOBS + [("serve_buckets", "8")] + list(extra)


def _images(rng, n=BATCH):
    """Per-image contrast and colour offset, so the pooled features and
    the classes differ between rows."""
    base = rng.randn(n, IMAGE, IMAGE, 3).astype(np.float32)
    return base * rng.uniform(0.2, 3.0, (n, 1, 1, 3)).astype(np.float32) \
        + 2 * rng.randn(n, 1, 1, 3).astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A float32 snapshot of Inception-BN-tiny with realistic BN stats
    (one training-mode forward's moments, written by the port), and the
    same snapshot after the JAX package calibrated it on two batches
    (its ``task = quantize`` sequence: Calibrator, finish,
    set_quantization, save)."""
    d = tmp_path_factory.mktemp("port_quantize")
    rng = np.random.RandomState(0)
    p = NetTrainer(_cfg(), device="cpu")
    p.init_model()
    with torch.no_grad():
        _, moved, _ = p.net.forward(p.params, p.net_state,
                                    torch.from_numpy(_images(rng)),
                                    is_train=True)
    # the running averages start at zero with momentum 0.9
    p.net_state = {lk: {k: v / 0.1 for k, v in st.items()}
                   for lk, st in moved.items()}
    f32_path = str(d / "f32.model.npz")
    p.save_model(f32_path)
    t = JaxTrainer(_cfg())
    t.load_model(f32_path)
    calib = [_images(rng) for _ in range(2)]
    cal = jq.Calibrator(t)
    for x in calib:
        cal.observe(JaxBatch(data=x, label=np.zeros((BATCH, 1), np.float32)))
    tables = cal.finish()
    t.set_quantization(tables, {"dtype": "int8", "batches": len(calib),
                                "bn_fold_eval": True})
    q_path = str(d / "int8.model.npz")
    t.save_model(q_path)
    return {"dir": d, "f32": f32_path, "int8": q_path, "tables": tables,
            "calib": calib, "x": _images(rng)}


# ------------------------------------------------------------ pieces


@pytest.mark.parametrize("val", ["f32", "float32", "bf16", "bfloat16",
                                 "int8"])
def test_normalize_serve_dtype_matches_jax(val):
    assert pq.normalize_serve_dtype(val) == jq.normalize_serve_dtype(val)


@pytest.mark.parametrize("val", ["fp8", "float8", "float8_e4m3", "int4"])
def test_normalize_serve_dtype_rejects(val):
    """int4 is rejected by both packages; the fp8 names (ported) are
    accepted by both as ``fp8``."""
    if val != "int4":
        assert pq.normalize_serve_dtype(val) \
            == jq.normalize_serve_dtype(val) == "fp8"
        return
    with pytest.raises(ValueError) as pe:
        pq.normalize_serve_dtype(val)
    assert not isinstance(pe.value, NotPortedError)
    with pytest.raises(ValueError):
        jq.normalize_serve_dtype(val)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_tensor_matches_jax(native, per_channel):
    """Exact .5 ties (a power-of-two scale divides exactly), values
    beyond +-amax, and random data at a random scale."""
    rng = np.random.RandomState(1)
    ties = (np.arange(-300, 300, dtype=np.float32) + 0.5) * 0.25
    v = np.concatenate([ties, rng.randn(900).astype(np.float32) * 40,
                        [1e9, -1e9, 0.0, -0.0]]).astype(np.float32)
    v = v.reshape(-1, 4)
    if per_channel:
        scale = np.array([0.25, 0.0137, 0.5, 0.3], np.float32)
    else:
        scale = np.float32(0.25 if native else 0.0137)
    want = np.asarray(jq.quantize_tensor(jnp.asarray(v), jnp.asarray(scale),
                                         "int8", native))
    got = pq.quantize_tensor(torch.from_numpy(v), torch.tensor(scale),
                             "int8", native).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if native:
        assert got.max() == 127 and got.min() == -127


@pytest.mark.parametrize("case", ["1x1", "3x3_pad", "7x7_s2", "k_ragged",
                                  "dot_small_m", "dot_ragged"])
def test_int8_contractions_match_jax(case):
    """conv_int8 / dot_int8 on the same int8 operands as
    ``lax.conv_general_dilated`` / ``jnp.dot`` with int32 accumulation:
    exactly equal (K not a multiple of 8 and M below 17 pad with
    zeros)."""
    rng = np.random.RandomState(2)

    def i8(*shape):
        return rng.randint(-127, 128, shape).astype(np.int8)
    if case.startswith("dot"):
        m, k, n = (3, 64, 16) if case == "dot_small_m" else (21, 37, 11)
        x, w = i8(m, k), i8(k, n)
        want = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                       preferred_element_type=jnp.int32)
        got = dot_int8(torch.from_numpy(x), pack_weight(torch.from_numpy(w)),
                       n)
    else:
        b, h, c, n, k, s, p = {"1x1": (2, 8, 16, 24, 1, 1, 0),
                               "3x3_pad": (2, 9, 8, 16, 3, 1, 1),
                               "7x7_s2": (2, 15, 3, 8, 7, 2, 3),
                               "k_ragged": (1, 7, 5, 7, 3, 2, 0)}[case]
        x, w = i8(b, h, h, c), i8(k, k, c, n)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (s, s), [(p, p), (p, p)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        got = conv_int8(torch.from_numpy(x),
                        pack_weight(torch.from_numpy(w)), n, k, k, s, p, p)
        assert got.is_contiguous()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("native", [True, False])
def test_quantized_conv_layer_matches_jax(native):
    """One conv layer's quantized eval forward (the in-graph path:
    weight quantized per call, the dequant through conv_epilogue) from
    the same weights and scales; ``native = False`` is the grouped conv's
    simulated path (grid values contracted in float32)."""
    rng = np.random.RandomState(3)
    group = 1 if native else 2
    text = ("nchannel = 12\nkernel_size = 3\npad = 1\nstride = 1\n"
            "ngroup = %d\nconv_pallas_epilogue = 1\n" % group)
    pairs = parse_config(text)
    jl, pl_ = jax_conv.ConvolutionLayer(jax_parse(text)), \
        port_conv.ConvolutionLayer(pairs)
    from cxxnet_tpu.layers.base import Shape3 as JShape
    from cxxnet_tpu_torch.layers.base import Shape3
    jl.infer_shape([JShape(8, 6, 6)])
    pl_.infer_shape([Shape3(8, 6, 6)])
    w = rng.randn(3, 3, 8 // group, 12).astype(np.float32)
    bias = rng.randn(12).astype(np.float32)
    x = rng.randn(2, 6, 6, 8).astype(np.float32) * 2
    x_scale = float(np.abs(x).max() / 127.0)
    w_scale = (np.abs(w).max(axis=(0, 1, 2)) / 127.0).astype(np.float32)
    jl._quant = jq.QuantSpec("int8", x_scale, jnp.asarray(w_scale), native)
    pl_._quant = pq.QuantSpec("int8", x_scale, torch.from_numpy(w_scale),
                              native)
    (want,), _ = jl.forward({"wmat": jnp.asarray(w),
                             "bias": jnp.asarray(bias)}, {},
                            [jnp.asarray(x)], False, None)
    (got,), _ = pl_.forward({"wmat": torch.from_numpy(w),
                             "bias": torch.from_numpy(bias)}, {},
                            [torch.from_numpy(x)], False)
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - want) <= _fma_tol(want - bias, want))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 5, 5, 24), (3, 7, 7, 6), (16, 40)])
def test_conv_epilogue_int32_matches_pallas(shape, relu, out_dtype):
    """The plain version on an int32 accumulator with values beyond
    +-2^24 (where float32 rounds the conversion) against the Pallas
    kernel: float32 within one ulp, bfloat16 within one bf16 ulp."""
    rng = np.random.RandomState(sum(shape))
    x = rng.randint(-40_000_000, 40_000_000, shape).astype(np.int32)
    c = shape[-1]
    s = (rng.rand(c) * 1e-6).astype(np.float32)
    t = rng.randn(c).astype(np.float32)
    want = np.asarray(jax_epilogue(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(t), relu,
                                   getattr(jnp, out_dtype))
                      .astype(jnp.float32))
    kernels.reset_launch_counts()
    got = kernels.conv_epilogue(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(t), relu,
                                getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    g = got.float().numpy()
    tol = _fma_tol(x.astype(np.float32) * s, want)
    if out_dtype == "bfloat16":
        tol = tol + np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(g - want) <= tol)
    assert np.abs(x).max() > 2 ** 24
    # a CPU tensor takes the plain version: no launch counted
    assert kernels.launch_counts()["conv_epilogue_int32"] == 0


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (6, 10)])
def test_conv_epilogue_backward_matches_jax(shape, relu):
    """Row 5b: the port's differentiable conv_epilogue (its backward the
    bn_apply backward's plain version on the CPU) against jax.grad of
    the Pallas conv_epilogue: rtol 1e-5 (f32 channel sums in another
    order)."""
    rng = np.random.RandomState(7)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    s = (rng.rand(c) + 0.5).astype(np.float32)
    t = (0.5 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)

    def f(x_, s_, t_):
        return jnp.sum(jax_epilogue(x_, s_, t_, relu, jnp.float32)
                       * jnp.asarray(dy))
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s),
                                         jnp.asarray(t))
    xt, st, tt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, s, t))
    y = kernels.conv_epilogue(xt, st, tt, relu)
    got = torch.autograd.grad(y, [xt, st, tt], torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    px, ps, pt = kernels.bn_apply_bwd_plain(
        xt.detach(), y.detach(), torch.from_numpy(dy), st.detach(), relu)
    for a, b in zip((px, ps, pt), got):
        assert torch.equal(a, b)


# ------------------------------------------------------ the slice


def test_calibrator_tables_match_jax(ref):
    """The port's Calibrator on the same float32 snapshot and batches:
    the same targets, activation ranges within rtol 2e-6, weight ranges
    (numpy over the folded weights in both) exactly."""
    t = NetTrainer(_cfg(), device="cpu")
    t.load_model(ref["f32"])
    cal = pq.Calibrator(t)
    for x in ref["calib"]:
        cal.observe(DataBatch(x))
    tables = cal.finish()
    want = ref["tables"]
    assert sorted(tables) == sorted(want)
    for lk in want:
        np.testing.assert_allclose(tables[lk]["x_amax"],
                                   want[lk]["x_amax"], rtol=2e-6)
        np.testing.assert_array_equal(tables[lk]["w_amax"],
                                      want[lk]["w_amax"])


def _jax_rows(path, dtype, rows):
    sess = JaxSession(jax_parse(_ser(dtype)), model_path=path)
    try:
        return sess.predict(rows)
    finally:
        sess.close()


def _ser(dtype):
    from cxxnet_tpu_torch.models import inception_bn_tiny as m
    return m(batch_size=BATCH, image_size=IMAGE) + "".join(
        "%s = %s\n" % kv for kv in KNOBS) \
        + "serve_buckets = 8\nserve_dtype = %s\n" % dtype


@pytest.mark.parametrize("dtype,atol", [("int8", INT8_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_session_matches_reference(ref, dtype, atol):
    """The whole slice: ServeSession(device="cpu") at serve_dtype int8
    (and bfloat16) from the snapshot the JAX package calibrated, against
    the reference's session on the same rows (8, and 3 padded to the
    bucket)."""
    rows = ref["x"]
    want = _jax_rows(ref["int8"], dtype, rows)
    sess = ServeSession(_cfg([("serve_dtype", dtype)]),
                        model_path=ref["int8"], device="cpu")
    try:
        got = sess.predict(rows)
        got3 = sess.predict(rows[:3])
        q = sess.engine.trainer
    finally:
        sess.close()
    assert q.quant_report["active"] and q.quant_report["layers"] == 21
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got3, want[:3], atol=atol, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    if dtype == "int8":
        assert q.quant_report["native"]


def test_frozen_int8_weights_match_jax(ref):
    """Each conv's and fullc's int8 weight (the fold multiplied in
    before it was quantized) against the reference's frozen serve tree:
    the in-graph folds compute the BN factor with rsqrt in each
    framework, so an int8 weight may move by one step where the float
    weight lies an ulp from a rounding boundary; at most 1e-4 of the
    weights may, and by one step only."""
    j = JaxTrainer(jax_parse(_ser("int8")))
    j.load_model(ref["int8"])
    jtree = j.freeze_serve_weights().tree
    p = NetTrainer(_cfg([("serve_dtype", "int8")]), device="cpu")
    p.load_model(ref["int8"])
    ptree = p.freeze_serve_weights()
    total = moved = 0
    for lk, sub in ptree.items():
        if "_wq" not in sub:
            continue
        jw = np.asarray(jtree[lk]["wmat"]).astype(np.int32)
        n = jw.shape[-1]
        want = jw.reshape(-1, n).T
        got = sub["_wq"].numpy()[:n, :want.shape[1]].astype(np.int32)
        d = np.abs(got - want)
        assert d.max() <= 1, lk
        total += d.size
        moved += int((d > 0).sum())
        np.testing.assert_array_equal(sub["_r_dequant"].numpy(),
                                      np.asarray(jtree[lk]["_r_dequant"]))
    assert total > 0 and moved <= 1e-4 * total


def test_int8_legacy_path_equals_frozen(ref):
    """serve_weight_residency = 0 quantizes per call what the frozen
    tree holds once: the same rows."""
    rows = ref["x"][:4]
    out = []
    for res in ("1", "0"):
        t = NetTrainer(_cfg([("serve_dtype", "int8"),
                             ("serve_weight_residency", res)]),
                       device="cpu")
        t.load_model(ref["int8"])
        out.append(t.extract_feature(DataBatch(rows), "top"))
    np.testing.assert_array_equal(out[0], out[1])


def test_bf16_serve_keeps_bf16_activations(ref):
    """The folded conv's epilogue emits bf16 under serve_dtype =
    bfloat16 (the reference's
    test_bf16_serve_epilogue_keeps_bf16_activations), and the engine
    stages bf16 rows whatever the caller's dtype."""
    t = NetTrainer(_cfg([("serve_dtype", "bfloat16")]), device="cpu")
    t.load_model(ref["f32"])
    with torch.inference_mode():
        nodes, _, _ = t.net.forward(
            t.freeze_serve_weights(), t.net_state,
            torch.from_numpy(ref["x"][:2]).to(torch.bfloat16))
    conv_out = t.graph.layers[0].nindex_out[0]
    assert nodes[conv_out].dtype == torch.bfloat16
    eng = InferenceEngine(t, buckets=(4,), input_dtype=torch.bfloat16)
    for src in (np.float32, np.float64, np.uint8):
        staged = eng.stage(np.zeros((3, IMAGE, IMAGE, 3), src))
        assert staged.data.dtype == torch.bfloat16
        assert eng.dispatch(staged).shape == (3, 8)


def test_port_quantized_snapshot_loads_in_reference(ref, tmp_path):
    """The port's calibrate, gate and save sequence on the float32
    snapshot: mean |int8 - f32| of the softmax rows within the 0.05 gate;
    the snapshot verifies in the reference (digest match) with the
    port's tables, and the reference serves its rows as the port
    does."""
    t = NetTrainer(_cfg(), device="cpu")
    t.load_model(ref["f32"])
    cal = pq.Calibrator(t)
    refs = []
    for x in ref["calib"]:
        refs.append(t.extract_feature(DataBatch(x), "top"))
        cal.observe(DataBatch(x))
    tables = cal.finish()
    t.set_quantization(tables, {"dtype": "int8", "batches": 2,
                                "bn_fold_eval": True}, dtype="int8")
    assert t.quant_report["active"] and t.quant_report["native"]
    diff = [np.abs(t.extract_feature(DataBatch(x), "top") - r).mean()
            for x, r in zip(ref["calib"], refs)]
    assert max(diff) <= GATE_EPS
    path = str(tmp_path / "port_int8.model.npz")
    t.save_model(path)
    rep = verify_snapshot(path)
    assert rep["ok"] and rep["digest"] == "match", rep
    blob, meta = jax_read(path)
    assert meta["quantized"]["dtype"] == "int8"
    got_tables = jq.tables_from_blob(blob)
    assert sorted(got_tables) == sorted(tables)
    for lk in tables:
        for f in ("x_amax", "w_amax"):
            np.testing.assert_array_equal(got_tables[lk][f], tables[lk][f])
    rows = ref["x"]
    want = _jax_rows(path, "int8", rows)
    np.testing.assert_allclose(t.extract_feature(DataBatch(rows), "top"),
                               want, atol=INT8_ATOL, rtol=0)


def test_reference_quantized_snapshot_roundtrips_through_port(ref,
                                                              tmp_path):
    """A reference-quantized snapshot, loaded and saved by the port,
    keeps its quant/ arrays and __meta__["quantized"], and verifies in
    the reference."""
    t = NetTrainer(_cfg(), device="cpu")
    t.load_model(ref["int8"])
    path = str(tmp_path / "again.model.npz")
    t.save_model(path)
    src_blob, src_meta = read_snapshot(ref["int8"])
    blob, meta = read_snapshot(path)
    qkeys = sorted(k for k in src_blob if k.startswith("quant/"))
    assert qkeys and qkeys == sorted(k for k in blob
                                     if k.startswith("quant/"))
    for k in qkeys:
        np.testing.assert_array_equal(blob[k], src_blob[k])
    assert meta["quantized"] == src_meta["quantized"]
    rep = verify_snapshot(path)
    assert rep["ok"] and rep["digest"] == "match", rep


def test_int8_without_tables_raises(ref):
    t = NetTrainer(_cfg([("serve_dtype", "int8")]), device="cpu")
    with pytest.raises(ValueError, match="calibrated snapshot"):
        t.load_model(ref["f32"])
    assert os.path.exists(ref["f32"])


SHARED_CONV_CONF = """
netconfig=start
layer[0->a] = conv:cvS
  nchannel = 3
  kernel_size = 3
  pad = 1
layer[a->b] = batch_norm:bn1
layer[b->c] = relu
layer[c->d] = share[cvS]
layer[d->e] = flatten
layer[e->f] = fullc:fc1
  nhidden = 4
layer[f->f] = softmax
netconfig=end
input_shape = 3,6,6
batch_size = 4
"""


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_shared_conv_freezes_layout_only(tmp_path, dtype):
    """A shared conv is no quantization target (one weight, two sites)
    and keeps its fold per call (every share site runs its object), as
    the reference's resident plan skips it; the frozen tree still holds
    its OIHW weight, and the rows equal serve_weight_residency = 0's."""
    rng = np.random.RandomState(3)
    cfg = parse_config(SHARED_CONV_CONF) + KNOBS
    x = rng.randn(4, 6, 6, 3).astype(np.float32)
    t = NetTrainer(cfg, device="cpu")
    t.init_model()
    path = str(tmp_path / "m.model.npz")
    if dtype == "int8":
        cal = pq.Calibrator(t)
        cal.observe(DataBatch(x))
        t.set_quantization(cal.finish(), {"dtype": "int8", "batches": 1},
                           dtype="int8")
    t.save_model(path)
    out = []
    for res in ("1", "0"):
        s = NetTrainer(cfg + [("serve_dtype", dtype),
                              ("serve_weight_residency", res)],
                       device="cpu")
        s.load_model(path)
        out.append(s.extract_feature(DataBatch(x), "top"))
        if res == "1":
            assert s.net.layer_objs[0]._quant is None
            frozen = s.freeze_serve_weights()[s.graph.layer_key(0)]
            assert sorted(frozen) == ["_oihw", "bias", "wmat"]
            np.testing.assert_array_equal(
                frozen["_oihw"].numpy(),
                s.params[s.graph.layer_key(0)]["wmat"].numpy()
                .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(out[0], out[1])
    assert np.all(np.isfinite(out[0]))
