"""Each layer of the port's serving slice against its JAX counterpart.

Same config, same numpy-seeded params and inputs into
``cxxnet_tpu.layers`` and ``cxxnet_tpu_torch.layers``; eval forwards.

Tolerances (float32): conv and fullc rtol 1e-5 / atol 1e-5 — the
contractions sum the same products in another order (the reference's
space-to-depth and grouped lowerings, oneDNN here); pooling, batch
norm, concat and activations 1e-6 — elementwise or window math where
only division-vs-reciprocal and FMA contraction differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.layers import Shape3 as JShape3
from cxxnet_tpu.layers import create_layer as jax_create
from cxxnet_tpu_torch.layers import Shape3, create_layer


def _pair(type_str, cfg, in_shapes):
    j = jax_create(type_str, list(cfg))
    p = create_layer(type_str, list(cfg))
    js = j.infer_shape([JShape3(*s) for s in in_shapes])
    ps = p.infer_shape([Shape3(*s) for s in in_shapes])
    assert [tuple(s) for s in js] == [tuple(s) for s in ps]
    return j, p


def _nhwc(rng, b, s, positive=False):
    ch, y, x = s
    shape = (b, x) if (ch == 1 and y == 1) else (b, y, x, ch)
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) if positive else a


def _forward(j, p, params, state, xs):
    jp = {k: (True if k == "_fold_relu" else jnp.asarray(v))
          for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    jout, _ = j.forward(jp, js, [jnp.asarray(x) for x in xs], False, None)
    pp = {k: (torch.ones(()) if k == "_fold_relu" else torch.from_numpy(v))
          for k, v in params.items()}
    ps = {k: torch.from_numpy(v) for k, v in state.items()}
    pout, _ = p.forward(pp, ps, [torch.from_numpy(x) for x in xs])
    assert len(jout) == len(pout)
    return ([np.asarray(v) for v in jout],
            [v.detach().numpy() for v in pout])


CONV_CASES = {
    # the stem shape class: 3 input channels, 7x7 stride 2 pad 3 (the
    # reference lowers it through its space-to-depth rewrite)
    "strided_entry": ([("nchannel", "8"), ("kernel_size", "7"),
                       ("stride", "2"), ("pad", "3"), ("no_bias", "1")],
                      (3, 15, 15), None),
    "grouped_bias": ([("nchannel", "12"), ("kernel_size", "3"),
                      ("ngroup", "2"), ("pad", "1")], (8, 9, 9), None),
    "pointwise": ([("nchannel", "6"), ("kernel_size", "1"),
                   ("no_bias", "1")], (5, 7, 7), None),
    "fold_epilogue_bias": ([("nchannel", "8"), ("kernel_size", "3"),
                            ("stride", "2"),
                            ("conv_pallas_epilogue", "1")],
                           (4, 11, 11), "relu"),
    "fold_epilogue_nobias_linear": ([("nchannel", "8"),
                                     ("kernel_size", "3"), ("pad", "1"),
                                     ("no_bias", "1"),
                                     ("conv_pallas_epilogue", "1")],
                                    (4, 6, 6), "linear"),
    "fold_weight_nobias": ([("nchannel", "8"), ("kernel_size", "3"),
                            ("pad", "1"), ("no_bias", "1")],
                           (4, 6, 6), "relu"),
    "fold_weight_bias": ([("nchannel", "8"), ("kernel_size", "1")],
                         (4, 6, 6), "linear"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case):
    cfg, in_shape, fold = CONV_CASES[case]
    rng = np.random.RandomState(sorted(CONV_CASES).index(case))
    j, p = _pair("conv", cfg, [in_shape])
    lp = p.param
    w = rng.randn(lp.kernel_height, lp.kernel_width,
                  lp.num_input_channel // lp.num_group,
                  lp.num_channel).astype(np.float32) * 0.2
    params = {"wmat": w}
    if lp.no_bias == 0:
        params["bias"] = rng.randn(lp.num_channel).astype(np.float32)
    if fold is not None:
        params["_fold_scale"] = (rng.rand(lp.num_channel) + 0.5
                                 ).astype(np.float32)
        params["_fold_shift"] = rng.randn(lp.num_channel).astype(np.float32)
        if fold == "relu":
            params["_fold_relu"] = None
    x = _nhwc(rng, 3, in_shape)
    (jy,), (py,) = _forward(j, p, params, {}, [x])
    assert py.shape == jy.shape
    np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-5)
    if fold == "relu":
        assert py.min() >= 0.0


def test_conv_output_is_dense_nhwc():
    """The conv hands the epilogue a dense NHWC tensor: permuting the
    channels-last conv output back costs no copy."""
    _, p = _pair("conv", [("nchannel", "8"), ("kernel_size", "3")],
                 [(4, 6, 6)])
    from cxxnet_tpu_torch.layers.conv import hwio_to_oihw
    w = hwio_to_oihw(torch.randn(3, 3, 4, 8))
    y = p.conv(torch.randn(2, 6, 6, 4), w)
    assert y.shape == (2, 4, 4, 8) and y.is_contiguous()


POOL_CASES = {
    # ceil-mode overhang: 10 -> 5 needs an 11-wide extent
    "max_3x3_s2_ceil": ("max_pooling", [("kernel_size", "3"),
                                        ("stride", "2")], (4, 10, 10)),
    # zero base pad (not -inf): visible on all-negative windows
    "max_3x3_s1_pad1": ("max_pooling", [("kernel_size", "3"),
                                        ("stride", "1"), ("pad", "1")],
                        (4, 7, 7)),
    "avg_3x3_s1_pad1": ("avg_pooling", [("kernel_size", "3"),
                                        ("stride", "1"), ("pad", "1")],
                        (4, 7, 7)),
    "avg_3x3_s2_ceil": ("avg_pooling", [("kernel_size", "3"),
                                        ("stride", "2")], (4, 10, 10)),
    "avg_global_7": ("avg_pooling", [("kernel_size", "7"),
                                     ("stride", "1")], (6, 7, 7)),
    "max_2x2_s2": ("max_pooling", [("kernel_size", "2"),
                                   ("stride", "2")], (4, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    type_str, cfg, in_shape = POOL_CASES[case]
    rng = np.random.RandomState(sorted(POOL_CASES).index(case))
    j, p = _pair(type_str, cfg, [in_shape])
    x = _nhwc(rng, 2, in_shape) - 1.0          # mostly negative
    (jy,), (py,) = _forward(j, p, {}, {}, [x])
    assert py.shape == jy.shape
    np.testing.assert_allclose(py, jy, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(6, 5, 5), (1, 1, 6)],
                         ids=["nhwc", "mat"])
@pytest.mark.parametrize("fuse_relu", [False, True],
                         ids=["plain", "fused_relu"])
def test_batch_norm_eval_matches_jax(shape, fuse_relu):
    rng = np.random.RandomState(7)
    j, p = _pair("batch_norm", [], [shape])
    j.fuse_relu = p.fuse_relu = fuse_relu
    c = p.channel
    params = {"wmat": (rng.rand(c) + 0.5).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32)}
    state = {"running_exp": (rng.randn(c) * 0.1).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    x = _nhwc(rng, 3, shape)
    (jy,), (py,) = _forward(j, p, params, state, [x])
    np.testing.assert_allclose(py, jy, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("type_str,shapes", [
    ("ch_concat", [(3, 4, 4), (5, 4, 4), (2, 4, 4)]),
    ("concat", [(1, 1, 3), (1, 1, 5)]),
    ("concat", [(2, 4, 3), (2, 4, 5)]),
], ids=["ch_concat", "concat_mat", "concat_x"])
def test_concat_matches_jax(type_str, shapes):
    rng = np.random.RandomState(11)
    j, p = _pair(type_str, [], shapes)
    xs = [_nhwc(rng, 2, s) for s in shapes]
    (jy,), (py,) = _forward(j, p, {}, {}, xs)
    np.testing.assert_array_equal(py, jy)


def test_flatten_fullc_matches_jax():
    """Flatten keeps the reference's NCHW feature order, so one (in,
    out) fullc weight means the same thing in both packages."""
    rng = np.random.RandomState(5)
    jf, pf = _pair("flatten", [], [(3, 4, 5)])
    jc, pc = _pair("fullc", [("nhidden", "7")], [(1, 1, 60)])
    x = _nhwc(rng, 2, (3, 4, 5))
    (jflat,), (pflat,) = _forward(jf, pf, {}, {}, [x])
    np.testing.assert_array_equal(pflat, jflat)
    params = {"wmat": rng.randn(60, 7).astype(np.float32),
              "bias": rng.randn(7).astype(np.float32)}
    (jy,), (py,) = _forward(jc, pc, params, {}, [pflat])
    np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("type_str", ["relu", "sigmoid", "tanh",
                                      "softplus", "softmax", "dropout"])
def test_elementwise_matches_jax(type_str):
    rng = np.random.RandomState(13)
    cfg = [("threshold", "0.5")] if type_str == "dropout" else []
    j, p = _pair(type_str, cfg, [(1, 1, 10)])
    x = (rng.randn(5, 10) * 4).astype(np.float32)
    (jy,), (py,) = _forward(j, p, {}, {}, [x])
    np.testing.assert_allclose(py, jy, rtol=1e-6, atol=1e-6)
    if type_str == "softmax":
        np.testing.assert_allclose(py.sum(1), 1.0, rtol=1e-6)


def test_split_matches_jax():
    j = jax_create("split", [], n_out=3)
    p = create_layer("split", [], n_out=3)
    assert [tuple(s) for s in j.infer_shape([JShape3(2, 3, 3)])] == \
        [tuple(s) for s in p.infer_shape([Shape3(2, 3, 3)])]
    x = np.random.RandomState(2).randn(2, 3, 3, 2).astype(np.float32)
    jy, py = _forward(j, p, {}, {}, [x])
    assert len(py) == 3
    for a, b in zip(jy, py):
        np.testing.assert_array_equal(b, a)


def test_vestigial_maxout_raises_the_reference_error():
    """``maxout`` is registered in the reference without an
    implementation: both factories raise the same ValueError, which is
    no NotPortedError (nothing will port it); an unknown type raises
    ValueError in both too (the reference's tests/test_layers.py:461)."""
    from cxxnet_tpu_torch.utils.config import NotPortedError
    with pytest.raises(ValueError) as jerr:
        jax_create("maxout", [])
    with pytest.raises(ValueError) as perr:
        create_layer("maxout", [])
    assert str(perr.value) == str(jerr.value)
    assert not isinstance(perr.value, NotPortedError)
    with pytest.raises(ValueError, match="unknown layer type"):
        create_layer("nonexistent_layer", [])


@pytest.mark.parametrize("fuse_relu", [False, True], ids=["plain", "relu"])
def test_batch_norm_eval_bf16_matches_jax(fuse_relu):
    """At eval a bf16 input normalizes in f32 and casts back, as the
    reference's eval path does (its training path applies scale and
    shift in bf16 instead): one bf16 ulp of the reference value, as the
    reference's rsqrt rounds once more than the port's."""
    rng = np.random.RandomState(4)
    c = 6
    x = rng.randn(2, 3, 4, c).astype(np.float32) * 2 + 1
    st = {"running_exp": rng.randn(c).astype(np.float32),
          "running_var": (rng.rand(c) + 0.5).astype(np.float32)}
    cfg = [("init_slope", "1.5"), ("init_bias", "0.2")]
    jl, pl = jax_create("batch_norm", cfg), create_layer("batch_norm", cfg)
    jl.infer_shape([JShape3(c, 3, 4)])
    pl.infer_shape([Shape3(c, 3, 4)])
    jl.fuse_relu = pl.fuse_relu = fuse_relu
    xt = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in jl.init_params(None).items()}
    (jo,), _ = jl.forward(jp, {k: jnp.asarray(v) for k, v in st.items()},
                          [xj], False, None)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    (po,), _ = pl.forward(pp, {k: torch.from_numpy(v) for k, v in st.items()},
                          [xt], False)
    assert po.dtype == torch.bfloat16 and str(jo.dtype) == "bfloat16"
    ref = np.asarray(jo, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(po.float().numpy() - ref) <= ulp)
