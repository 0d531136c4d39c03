"""The port's fp8 serving (``serve_dtype = fp8``) against the JAX
package, on the CPU.

Inputs are made from a seed with numpy and go through the reference's
function and the port's counterpart. Tolerances, each with its reason:

- quantization (``quantize_tensor``) and the frozen e4m3 weights: the
  same bits. Both divide by the float32 scale, clamp to +-448 and cast
  to e4m3 with round to nearest even (ties, values beyond +-amax and
  subnormals included);
- the e4m3 contractions (``conv_fp8``, ``dot_fp8``) against XLA's fp8
  convolution and dot with float32 accumulation: each product of two
  e4m3 values is exact in float32, so only the order of the float32
  sum differs: within ``K * 2^-24 * sum |a_i b_i|`` (the classical bound
  of a K-term float32 sum in any order);
- a calibrated conv + BN net served at fp8: softmax rows within atol
  1e-4 and the same top-1. The contractions differ by the sum order
  above, the float32 epilogue by one rounding of a fused multiply-add
  (``tests/test_torch_port_quantize.py``), and an activation within such
  a rounding of an e4m3 rounding boundary may move by one e4m3 step
  (2^-3 relative) before the next layer;
- ``task = quantize quantize_dtype = fp8`` through both CLIs: the same
  layers, activation ranges within rtol 2e-6 (float32 activations summed
  in another order), weight ranges exactly, both under the 0.05 gate.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.layers import conv as jax_conv
from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.nnet import quantize as jq
from cxxnet_tpu.nnet.checkpoint import read_snapshot as ref_read
from cxxnet_tpu.nnet.checkpoint import write_snapshot as ref_write
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.parallel import make_mesh
from cxxnet_tpu.serve import ServeSession as JaxSession
from cxxnet_tpu.utils.config import parse_config as jax_parse
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layers import conv as port_conv
from cxxnet_tpu_torch.layers.quant_ops import (FP8, conv_fp8, dot_fp8,
                                               pack_weight)
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.nnet import quantize as pq
from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import ServeSession
from cxxnet_tpu_torch.utils.config import parse_config
from tests.test_trainer import synth_idx

FP8_ATOL = 1e-4
GATE_EPS = 0.05

NET = """
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
layer[1->2] = batch_norm:bn1
layer[2->3] = relu
layer[3->4] = conv:c2
  kernel_size = 3
  stride = 2
  nchannel = 16
layer[4->5] = batch_norm:bn2
layer[5->6] = relu
layer[6->7] = flatten
layer[7->8] = fullc:fc
  nhidden = 4
layer[8->8] = softmax
netconfig=end
input_shape = 1,8,8
batch_size = 16
bn_fold_eval = 1
bn_fuse_relu = 1
conv_pallas_epilogue = 1
serve_buckets = 4,16
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sum_tol(k, abs_sum):
    """``K * 2^-24 * sum |a_i b_i|`` of a contraction over ``K`` terms;
    ``abs_sum`` is that contraction of the operands' magnitudes."""
    return k * 2.0 ** -24 * abs_sum


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A reference snapshot with BN statistics a fold can use, over 64
    seeded 8x8 digits; the reference's ``task = quantize quantize_dtype
    = fp8`` of it; the rows the sessions are held on."""
    d = tmp_path_factory.mktemp("port_fp8")
    pimg, plab = synth_idx(str(d), n=64, d=8, name="fp8")
    conf = str(d / "q.conf")
    with open(conf, "w") as f:
        f.write("""data = train
iter = mnist
  path_img = "%s"
  path_label = "%s"
  input_flat = 0
  silent = 1
iter = end
%s""" % (pimg, plab, NET))
    snap = str(d / "f32.model.npz")
    t = JaxTrainer(jax_parse(NET), mesh=make_mesh(1, 1))
    t.init_model()
    t.save_model(snap)
    arrays, meta = ref_read(snap)
    rng = np.random.RandomState(5)
    for k in list(arrays):
        if k.endswith("/running_exp"):
            arrays[k] = (0.1 * rng.rand(*arrays[k].shape)).astype(
                np.float32)
        if k.endswith("/running_var"):
            arrays[k] = (0.5 + rng.rand(*arrays[k].shape)).astype(
                np.float32)
    meta = {k: v for k, v in meta.items() if k != "content_digest"}
    ref_write(snap, arrays, meta, fsync=False)
    return {"dir": d, "conf": conf, "snap": snap,
            "x": rng.rand(16, 8, 8, 1).astype(np.float32) * 2}


def _quantize(task_cls, ref, out, extra=()):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = task_cls().run([ref["conf"], "task=quantize",
                             "model_in=" + ref["snap"],
                             "quantize_dtype=fp8", "quantize_batches=2",
                             "quantize_out=" + out] + list(extra))
    assert rc == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def quantized(ref):
    d = ref["dir"]
    rpath, ppath = str(d / "ref.fp8.npz"), str(d / "port.fp8.npz")
    return {"ref": rpath, "port": ppath,
            "ref_out": _quantize(RefTask, ref, rpath),
            "port_out": _quantize(LearnTask, ref, ppath, ["dev=cpu"])}


# ------------------------------------------------------------ pieces


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_tensor_fp8_matches_jax(native, per_channel):
    """Exact e4m3 ties (the midpoints of two grid values), values beyond
    +-448 after the division, subnormals (below 2^-6) and random data."""
    rng = np.random.RandomState(1)
    grid = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    e4m3 = grid.view(FP8).float().numpy()
    e4m3 = np.unique(e4m3[np.isfinite(e4m3)])
    ties = ((e4m3[1:] + e4m3[:-1]) / 2).astype(np.float32)
    sub = np.linspace(-2 ** -6, 2 ** -6, 101, dtype=np.float32)
    v = np.concatenate([ties, sub, rng.randn(1000).astype(np.float32) * 200,
                        [1e9, -1e9, 0.0, -0.0, 448.0, 464.0, -500.0,
                         2 ** -10]]).astype(np.float32)
    v = v[:v.size // 4 * 4].reshape(-1, 4)
    scale = np.array([1.0, 0.37, 2.0, 1e-3], np.float32) if per_channel \
        else np.float32(1.0)
    want = np.asarray(jq.quantize_tensor(jnp.asarray(v), jnp.asarray(scale),
                                         "fp8", native))
    got = pq.quantize_tensor(torch.from_numpy(v), torch.tensor(scale),
                             "fp8", native)
    if native:
        assert got.dtype == FP8
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                      want.view(np.uint8))
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def _e4m3(rng, *shape):
    x = (rng.randn(*shape) * 60).astype(np.float32)
    return pq.quantize_tensor(torch.from_numpy(x), torch.tensor(1.0),
                              "fp8", True)


@pytest.mark.parametrize("case", ["1x1", "3x3_pad", "7x7_s2", "k_ragged",
                                  "dot_small_m", "dot_ragged"])
def test_fp8_contractions_match_jax(case):
    """conv_fp8 / dot_fp8 against ``lax.conv_general_dilated`` /
    ``jnp.dot`` on the same e4m3 operands with float32 accumulation (K
    and N not multiples of 16 pad with zeros)."""
    rng = np.random.RandomState(2)
    if case.startswith("dot"):
        m, k, n = (3, 64, 16) if case == "dot_small_m" else (21, 37, 11)
        x, w = _e4m3(rng, m, k), _e4m3(rng, k, n)
        xf, wf = x.float().numpy(), w.float().numpy()
        want = jnp.dot(jnp.asarray(xf).astype(jnp.float8_e4m3fn),
                       jnp.asarray(wf).astype(jnp.float8_e4m3fn),
                       preferred_element_type=jnp.float32)
        got = dot_fp8(x, pack_weight(w, "fp8"), n)
        tol = _sum_tol(k, np.abs(xf).astype(np.float64)
                       @ np.abs(wf).astype(np.float64))
    else:
        b, h, c, n, k, s, p = {"1x1": (2, 8, 16, 24, 1, 1, 0),
                               "3x3_pad": (2, 9, 8, 16, 3, 1, 1),
                               "7x7_s2": (2, 15, 3, 8, 7, 2, 3),
                               "k_ragged": (1, 7, 5, 7, 3, 2, 0)}[case]
        x, w = _e4m3(rng, b, h, h, c), _e4m3(rng, k, k, c, n)
        xf, wf = x.float().numpy(), w.float().numpy()

        want = jax.lax.conv_general_dilated(
            jnp.asarray(xf).astype(jnp.float8_e4m3fn),
            jnp.asarray(wf).astype(jnp.float8_e4m3fn), (s, s),
            [(p, p), (p, p)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)
        got = conv_fp8(x, pack_weight(w, "fp8"), n, k, k, s, p, p)
        assert got.is_contiguous()
        mags = torch.nn.functional.conv2d(
            torch.from_numpy(np.abs(xf)).double().permute(0, 3, 1, 2),
            torch.from_numpy(np.abs(wf)).double().permute(3, 2, 0, 1),
            stride=s, padding=p).permute(0, 2, 3, 1).numpy()
        tol = _sum_tol(k * k * c, mags)
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= tol)


def test_pack_weight_fp8_layout():
    """The (N, K) row-major e4m3 matrix, K and N padded to 16 with zeros
    (the bytes of +0)."""
    rng = np.random.RandomState(4)
    w = _e4m3(rng, 3, 3, 5, 7)
    m = pack_weight(w, "fp8")
    assert m.dtype == FP8 and m.shape == (16, 48) and m.is_contiguous()
    u = m.view(torch.uint8)
    assert not u[7:].any() and not u[:, 45:].any()
    np.testing.assert_array_equal(
        u[:7, :45].numpy(),
        w.view(torch.uint8).reshape(45, 7).t().numpy())


@pytest.mark.parametrize("native", [True, False])
def test_fp8_conv_layer_matches_jax(native):
    """One conv layer's fp8 eval forward (the weight quantized per call,
    the dequant through conv_epilogue) from the same weights and scales;
    ``native = False`` is the grouped conv's simulated path."""
    rng = np.random.RandomState(3)
    group = 1 if native else 2
    text = ("nchannel = 12\nkernel_size = 3\npad = 1\nstride = 1\n"
            "ngroup = %d\nconv_pallas_epilogue = 1\n" % group)
    jl = jax_conv.ConvolutionLayer(jax_parse(text))
    pl_ = port_conv.ConvolutionLayer(parse_config(text))
    from cxxnet_tpu.layers.base import Shape3 as JShape
    from cxxnet_tpu_torch.layers.base import Shape3
    jl.infer_shape([JShape(8, 6, 6)])
    pl_.infer_shape([Shape3(8, 6, 6)])
    w = rng.randn(3, 3, 8 // group, 12).astype(np.float32)
    bias = rng.randn(12).astype(np.float32)
    x = rng.randn(2, 6, 6, 8).astype(np.float32) * 2
    x_scale = float(np.abs(x).max() / 448.0)
    w_scale = (np.abs(w).max(axis=(0, 1, 2)) / 448.0).astype(np.float32)
    jl._quant = jq.QuantSpec("fp8", x_scale, jnp.asarray(w_scale), native)
    pl_._quant = pq.QuantSpec("fp8", x_scale, torch.from_numpy(w_scale),
                              native)
    (want,), _ = jl.forward({"wmat": jnp.asarray(w),
                             "bias": jnp.asarray(bias)}, {},
                            [jnp.asarray(x)], False, None)
    (got,), _ = pl_.forward({"wmat": torch.from_numpy(w),
                             "bias": torch.from_numpy(bias)}, {},
                            [torch.from_numpy(x)], False)
    want = np.asarray(want)
    assert got.dtype == torch.float32
    # sum order over 72 (36 grouped) terms, then one fma rounding
    scale = np.abs(want - bias) + np.abs(bias)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=float(scale.max()) * 72 * 2.0 ** -23)


# ------------------------------------------------------ the slice


def test_quantize_fp8_through_both_clis(ref, quantized):
    pat = r"quantize\[fp8\]: (\d+) layers \(0 fallback\) over (\d+) " \
          r"batches, parity mean\|Δ\| (\S+) .* — wrote"
    mr = re.search(pat, quantized["ref_out"])
    mp = re.search(pat, quantized["port_out"])
    assert mr and mp, quantized["port_out"]
    assert mp.group(1) == mr.group(1) == "3"
    assert mp.group(2) == mr.group(2) == "2"
    assert float(mp.group(3)) <= GATE_EPS
    parr, pmeta = read_snapshot(quantized["port"])
    rarr, rmeta = read_snapshot(quantized["ref"])
    assert pmeta["quantized"]["dtype"] == rmeta["quantized"]["dtype"] \
        == "fp8"
    qkeys = sorted(k for k in rarr if k.startswith("quant/"))
    assert qkeys and qkeys == sorted(k for k in parr
                                     if k.startswith("quant/"))
    for k in qkeys:
        if k.endswith("w_amax"):
            np.testing.assert_array_equal(parr[k], rarr[k], err_msg=k)
        else:
            np.testing.assert_allclose(parr[k], rarr[k], rtol=2e-6,
                                       err_msg=k)


def _serve_cfg(extra=()):
    return parse_config(NET) + [("serve_dtype", "fp8")] + list(extra)


def test_session_fp8_matches_reference(ref, quantized):
    """ServeSession(device="cpu") at serve_dtype = fp8 from the snapshot
    the reference's CLI quantized, against the reference's session on
    16 rows and 3 (padded to bucket 4)."""
    rows = ref["x"]
    js = JaxSession(jax_parse(NET + "serve_dtype = fp8\n"),
                    model_path=quantized["ref"])
    try:
        want = js.predict(rows)
    finally:
        js.close()
    sess = ServeSession(_serve_cfg(), model_path=quantized["ref"],
                        device="cpu")
    try:
        got = sess.predict(rows)
        got3 = sess.predict(rows[:3])
        rep = sess.engine.trainer.quant_report
    finally:
        sess.close()
    assert rep["active"] and rep["native"] and rep["dtype"] == "fp8"
    assert rep["layers"] == 3
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=FP8_ATOL, rtol=0)
    np.testing.assert_allclose(got3, want[:3], atol=FP8_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_frozen_fp8_weights_match_jax(quantized):
    """Each conv's and fullc's e4m3 weight (the fold multiplied in
    before it was quantized) and its dequant vector against the
    reference's frozen serve tree: the same bits."""
    j = JaxTrainer(jax_parse(NET + "serve_dtype = fp8\n"),
                   mesh=make_mesh(1, 1))
    j.load_model(quantized["ref"])
    jtree = j.freeze_serve_weights().tree
    p = NetTrainer(_serve_cfg(), device="cpu")
    p.load_model(quantized["ref"])
    ptree = p.freeze_serve_weights()
    seen = 0
    for lk, sub in ptree.items():
        if "_wq" not in sub:
            continue
        assert sub["_wq"].dtype == FP8
        jw = np.asarray(jtree[lk]["wmat"])
        n = jw.shape[-1]
        want = jw.view(np.uint8).reshape(-1, n).T
        got = sub["_wq"].view(torch.uint8).numpy()[:n, :want.shape[1]]
        np.testing.assert_array_equal(got, want, err_msg=lk)
        np.testing.assert_array_equal(sub["_r_dequant"].numpy(),
                                      np.asarray(jtree[lk]["_r_dequant"]))
        seen += 1
    assert seen == 3


def test_fp8_legacy_path_equals_frozen(ref, quantized):
    """serve_weight_residency = 0 quantizes per call what the frozen
    tree holds once: the same rows."""
    out = []
    for res in ("1", "0"):
        t = NetTrainer(_serve_cfg([("serve_weight_residency", res)]),
                       device="cpu")
        t.load_model(quantized["port"])
        out.append(t.extract_feature(DataBatch(ref["x"]), "top"))
    np.testing.assert_array_equal(out[0], out[1])
