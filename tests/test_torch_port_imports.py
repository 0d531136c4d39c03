"""Guards of the PyTorch port (cxxnet_tpu_torch/): it stands alone, and
its entry points never fall back to the CPU when a GPU was asked for.

The import guard reads the sources (AST): this interpreter may preload
jax at start-up, so ``sys.modules`` cannot tell what the port imports.
"""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "cxxnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "cxxnet_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_sources_found():
    srcs = _port_sources()
    assert os.path.join(ROOT, "chip_smoke.py") in srcs
    assert len(srcs) > 15


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_no_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, "%s imports %s" % (os.path.relpath(path, ROOT), bad)


def test_guard_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nfrom cxxnet_tpu.graph import NetGraph\n"
                 "def f():\n    import jax.numpy as jnp\n")
    assert _imported_roots(str(p)) & set(FORBIDDEN) == {"cxxnet_tpu",
                                                        "jax"}


def _tiny_cfg():
    from cxxnet_tpu_torch.models import inception_bn_tiny
    from cxxnet_tpu_torch.utils.config import parse_config
    return parse_config(inception_bn_tiny(batch_size=4, image_size=16))


def test_cuda_request_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract is moot")
    from cxxnet_tpu_torch.device import resolve_device
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import ServeSession
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NetTrainer(_tiny_cfg())                 # default device: cuda
    t = NetTrainer(_tiny_cfg(), device="cpu")
    t.init_model()
    path = str(tmp_path / "m.model.npz")
    t.save_model(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeSession(_tiny_cfg(), model_path=path)


def test_kernel_wrapper_on_cpu_tensor_counts_no_launch():
    from cxxnet_tpu_torch.layers import kernels
    kernels.reset_launch_counts()
    x = torch.from_numpy(np.ones((2, 3, 3, 4), np.float32))
    s = torch.ones(4)
    kernels.conv_epilogue(x, s, torch.zeros(4), True)
    kernels.bn_apply(x, s, torch.zeros(4), True)
    kernels.matmul(x.reshape(6, 12), x.reshape(12, 6))
    xg = x.clone().requires_grad_(True)
    kernels.relu_max_pool(xg, 2).sum().backward()
    counts = kernels.launch_counts()
    assert set(counts) == {"conv_epilogue", "bn_apply_fwd", "bn_apply_bwd",
                           "matmul", "relu_max_pool_fwd",
                           "relu_max_pool_bwd"}
    assert all(v == 0 for v in counts.values())
