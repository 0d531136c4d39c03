"""The port's conv_epilogue against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes the kernel's plain version (the
CUDA kernel runs only on the card, where chip_smoke.py holds it against
the same plain version); the reference runs its Pallas kernel in
interpret mode, as tests/test_pallas.py runs it. Same numpy-seeded
inputs into both.

Tolerances:
- float32 out: rtol 1e-6 (+ atol 1e-6 on O(1) values): both compute
  x*scale + shift in f32, but XLA may contract the multiply-add into
  one FMA where PyTorch rounds twice, so results near zero can differ
  by one rounding of the product.
- bfloat16 out: one bf16 ulp of the reference value, for the same
  reason surfacing through the final round to 8 mantissa bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.layers.pallas_kernels import conv_epilogue as jax_epilogue
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.utils.config import NotPortedError

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits), floored at the
    smallest normal's ulp."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _inputs(shape, in_dtype, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    s = (rng.rand(c) + 0.5).astype(np.float32)
    t = rng.randn(c).astype(np.float32)
    xt = torch.from_numpy(x).to(in_dtype)
    # the reference sees exactly the values the port sees
    xj = jnp.asarray(xt.float().numpy()).astype(_JDT[in_dtype])
    return xt, torch.from_numpy(s), torch.from_numpy(t), xj, s, t


@pytest.mark.parametrize("shape", [(2, 6, 10, 24), (5, 24), (3, 4, 5, 7)],
                         ids=["nhwc", "mat", "nhwc_ragged_c"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)],
    ids=["f32_f32", "f32_bf16", "bf16_bf16", "bf16_f32"])
def test_conv_epilogue_plain_matches_pallas(shape, relu, in_dtype,
                                            out_dtype):
    kernels.reset_launch_counts()
    x, s, t, xj, sj, tj = _inputs(shape, in_dtype, seed=len(shape))
    got = kernels.conv_epilogue(x, s, t, relu, out_dtype)
    ref = np.asarray(jax_epilogue(xj, jnp.asarray(sj), jnp.asarray(tj),
                                  relu, _JDT[out_dtype]).astype(jnp.float32))
    assert got.dtype == out_dtype and tuple(got.shape) == shape
    g = got.float().numpy()
    if out_dtype == torch.float32:
        np.testing.assert_allclose(g, ref, rtol=1e-6, atol=1e-6)
    else:
        assert np.all(np.abs(g - ref) <= _bf16_ulp(ref))
    if relu:
        assert g.min() >= 0.0
    # CPU tensors take the plain version: no kernel launch counted
    assert kernels.conv_epilogue.launches == 0


def test_conv_epilogue_wrapper_equals_plain():
    x, s, t, _, _, _ = _inputs((2, 3, 3, 8), torch.float32, seed=3)
    a = kernels.conv_epilogue(x, s, t, True)
    b = kernels.conv_epilogue_plain(x, s, t, True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["int32", "f64", "3d", "scale_shape",
                                  "scale_dtype", "noncontig",
                                  "out_dtype"])
def test_conv_epilogue_wrapper_rejects(case):
    x = torch.zeros(2, 3, 3, 4)
    s, t = torch.ones(4), torch.zeros(4)
    out = torch.float32
    err = ValueError
    if case == "int32":
        x, err = x.to(torch.int32), NotPortedError
    elif case == "f64":
        x, err = x.double(), TypeError
    elif case == "3d":
        x = torch.zeros(2, 3, 4)
    elif case == "scale_shape":
        s = torch.ones(5)
    elif case == "scale_dtype":
        s = torch.ones(4, dtype=torch.float64)
    elif case == "noncontig":
        x = torch.zeros(2, 4, 3, 3).permute(0, 2, 3, 1)
    elif case == "out_dtype":
        out, err = torch.float16, TypeError
    with pytest.raises(err):
        kernels.conv_epilogue(x, s, t, True, out)
