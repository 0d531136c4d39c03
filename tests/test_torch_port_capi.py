"""The port's C ABI (``cxxnet_tpu_torch/capi``) against the port's Python
API and the reference's C ABI (``lib/libcxxnet_wrapper.so``, built from
``wrapper/cxxnet_wrapper.cc`` by ``make``).

The library is built here with ``g++`` at first use and loaded with
ctypes into this interpreter (it then only takes the GIL); the
standalone C program and the unchanged Matlab mex driver link against
it and start an interpreter of their own. ``tests/test_cwrapper.py``'s
call sequences run on ``"cpu"``.

Tolerances: through the port's library the values are the port's
``wrapper.Net`` bits (the same calls on the same snapshot); against the
reference's library, from one reference snapshot, rtol 1e-4 / atol
1e-6 after updates, as ``tests/test_torch_port_wrapper.py`` holds the
two Python APIs (the reference averages gradients over its virtual CPU
devices, the port over one batch: float32 sums in another order).
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import capi
from cxxnet_tpu_torch.wrapper import DataIter, Net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_LIB = os.path.join(REPO, "lib", "libcxxnet_wrapper.so")
RTOL, ATOL = 1e-4, 1e-6

NET_CFG = b"""
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig = end
input_shape = 1,1,10
batch_size = 8
eta = 0.2
metric = error
"""

FP = ctypes.POINTER(ctypes.c_float)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bind(lib):
    lib.CXNNetCreate.restype = ctypes.c_void_p
    lib.CXNNetCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.CXNNetPredictBatch.restype = FP
    lib.CXNNetPredictIter.restype = FP
    lib.CXNNetExtractBatch.restype = FP
    lib.CXNNetGetWeight.restype = FP
    lib.CXNNetEvaluate.restype = ctypes.c_char_p
    lib.CXNGetLastError.restype = ctypes.c_char_p
    lib.CXNIOCreateFromConfig.restype = ctypes.c_void_p
    lib.CXNIOGetData.restype = FP
    lib.CXNIOGetLabel.restype = FP
    for f in (lib.CXNNetFree, lib.CXNNetInitModel, lib.CXNIOFree,
              lib.CXNIOBeforeFirst, lib.CXNIONext):
        f.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def lib():
    return _bind(ctypes.CDLL(capi.build_library()))


@pytest.fixture(scope="module")
def ref_lib():
    """The reference's library, built as ``tests/test_cwrapper.py``
    builds it."""
    if not os.path.exists(REF_LIB):
        subprocess.run(["make", "-s", "-C", REPO,
                        "lib/libcxxnet_wrapper.so"], check=True,
                       stdout=subprocess.DEVNULL)
    return _bind(ctypes.CDLL(REF_LIB))


def _shape4(*dims):
    a = (ctypes.c_uint * 4)()
    for i, d in enumerate(dims):
        a[i] = d
    return a


def _ptr(a):
    return a.ctypes.data_as(FP)


def _arr(p, shape):
    n = int(np.prod(shape))
    return np.ctypeslib.as_array(p, (n,)).reshape(shape).copy()


def _xy(seed=0):
    rng = np.random.RandomState(seed)
    return (np.ascontiguousarray(rng.rand(8, 1, 1, 10), np.float32),
            np.ascontiguousarray(rng.randint(0, 4, (8, 1)), np.float32))


class _CNet:
    """One ``CXNNet*`` handle of ``lib``, as the C calls see it."""

    def __init__(self, lib, dev: bytes, cfg: bytes = NET_CFG):
        self.lib = lib
        h = lib.CXNNetCreate(dev, cfg)
        assert h, lib.CXNGetLastError()
        self.h = ctypes.c_void_p(h)

    def update(self, x, y):
        self.lib.CXNNetUpdateBatch(self.h, _ptr(x), _shape4(*x.shape),
                                   _ptr(y), (ctypes.c_uint * 2)(*y.shape))

    def predict(self, x):
        n = ctypes.c_uint()
        p = self.lib.CXNNetPredictBatch(self.h, _ptr(x), _shape4(*x.shape),
                                        ctypes.byref(n))
        assert p, self.lib.CXNGetLastError()
        return _arr(p, (n.value,))

    def extract(self, x, node: bytes):
        shape = _shape4()
        p = self.lib.CXNNetExtractBatch(self.h, _ptr(x), _shape4(*x.shape),
                                        node, shape)
        assert p, self.lib.CXNGetLastError()
        return _arr(p, tuple(shape))

    def weight(self, layer: bytes, tag: bytes):
        shape, nd = _shape4(), ctypes.c_uint()
        p = self.lib.CXNNetGetWeight(self.h, layer, tag, shape,
                                     ctypes.byref(nd))
        if not p:
            return None
        return _arr(p, tuple(shape[:nd.value]))

    def free(self):
        self.lib.CXNNetFree(self.h)


def _entry_points(path):
    """The header's ``CXXNET_DLL`` declarations, whitespace-normalized,
    by name."""
    with open(path) as f:
        text = re.sub(r"/\*.*?\*/", "", f.read(), flags=re.S)
    decls = {}
    for m in re.finditer(r"CXXNET_DLL\s+([^;]*?)\b(CXN\w+)\s*\(([^)]*)\)",
                         text):
        decls[m.group(2)] = " ".join(
            (m.group(1) + m.group(2) + "(" + m.group(3) + ")").split())
    return decls


def test_header_declares_the_reference_entry_points():
    ref = _entry_points(os.path.join(REPO, "wrapper", "cxxnet_wrapper.h"))
    port = _entry_points(os.path.join(capi.CAPI_DIR, "cxxnet_wrapper.h"))
    assert len(ref) == 23
    assert port == ref


def test_source_embeds_only_the_port():
    with open(os.path.join(capi.CAPI_DIR, "cxxnet_wrapper.cc")) as f:
        src = f.read()
    assert "cxxnet_tpu." not in src and "jax" not in src
    assert '"cxxnet_tpu_torch.wrapper"' in src
    # the built library holds the same module name
    with open(capi.build_library(), "rb") as f:
        blob = f.read()
    assert b"cxxnet_tpu_torch.wrapper" in blob
    assert b"cxxnet_tpu.wrapper" not in blob


def test_c_abi_net_roundtrip(lib):
    """``tests/test_cwrapper.py``'s net sequence on ``"cpu"``, every value
    the port's ``wrapper.Net`` bits for the same calls."""
    net = _CNet(lib, b"cpu")
    lib.CXNNetInitModel(net.h)
    py = Net(dev="cpu", cfg=NET_CFG.decode())
    py.init_model()
    # the same seed, the same initial weights
    np.testing.assert_array_equal(net.weight(b"fc1", b"wmat"),
                                  py.get_weight("fc1", "wmat"))
    x, y = _xy()
    for r in range(3):
        lib.CXNNetStartRound(net.h, r)
        net.update(x, y)
        py.start_round(r)
        py.update(x, y)
    assert lib.CXNGetLastError() == b""
    pred = net.predict(x)
    assert pred.shape == (8,) and np.all((0 <= pred) & (pred <= 3))
    np.testing.assert_array_equal(pred, py.predict(x))
    w = net.weight(b"fc1", b"wmat")
    assert w.shape == (16, 10)
    np.testing.assert_array_equal(w, py.get_weight("fc1", "wmat"))
    assert net.weight(b"nosuch", b"wmat") is None
    # a flat set_weight reshapes against the stored (out, in) layout
    flat = np.full(160, 0.5, np.float32)
    lib.CXNNetSetWeight(net.h, _ptr(flat), 160, b"fc1", b"wmat")
    w3 = net.weight(b"fc1", b"wmat")
    assert w3.shape == (16, 10) and np.all(w3 == 0.5)
    lib.CXNNetSetWeight(net.h, _ptr(np.ascontiguousarray(w)), 160,
                        b"fc1", b"wmat")
    e = net.extract(x, b"top[-1]")
    assert e.shape == (8, 1, 1, 16)
    np.testing.assert_array_equal(e, py.extract(x, "top[-1]"))
    e2 = net.extract(x, b"top")
    assert e2.shape == (8, 1, 1, 4)
    np.testing.assert_array_equal(e2, py.extract(x, "top"))
    net.free()


def test_c_abi_matches_the_reference_library(lib, ref_lib, tmp_path):
    """One reference snapshot (written through the reference's C ABI)
    loaded through both libraries; three updates, predict, extract and
    the weights through each."""
    snap = str(tmp_path / "ref.model.npz").encode()
    ref = _CNet(ref_lib, b"tpu")
    ref_lib.CXNNetInitModel(ref.h)
    ref_lib.CXNNetSaveModel(ref.h, snap)
    port = _CNet(lib, b"cpu")
    lib.CXNNetLoadModel(port.h, snap)
    py = Net(dev="cpu", cfg=NET_CFG.decode())
    py.load_model(snap.decode())
    np.testing.assert_array_equal(port.weight(b"fc2", b"wmat"),
                                  ref.weight(b"fc2", b"wmat"))
    x, y = _xy(3)
    for r in range(3):
        for n, lb in ((ref, ref_lib), (port, lib)):
            lb.CXNNetStartRound(n.h, r)
            n.update(x, y)
        py.start_round(r)
        py.update(x, y)
    for layer in (b"fc1", b"fc2"):
        for tag in (b"wmat", b"bias"):
            got = port.weight(layer, tag)
            np.testing.assert_array_equal(
                got, py.get_weight(layer.decode(), tag.decode()))
            np.testing.assert_allclose(got, ref.weight(layer, tag),
                                       rtol=RTOL, atol=ATOL)
    top = port.extract(x, b"top")
    np.testing.assert_array_equal(top, py.extract(x, "top"))
    np.testing.assert_allclose(top, ref.extract(x, b"top"), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    # save / load through the port's library keeps every bit
    mine = str(tmp_path / "port.model.npz").encode()
    lib.CXNNetSaveModel(port.h, mine)
    again = _CNet(lib, b"cpu")
    lib.CXNNetLoadModel(again.h, mine)
    np.testing.assert_array_equal(again.predict(x), port.predict(x))
    np.testing.assert_array_equal(again.weight(b"fc1", b"wmat"),
                                  port.weight(b"fc1", b"wmat"))
    for n in (ref, port, again):
        n.free()


def _csv(tmp_path, n=32, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 10).astype(np.float32)
    yv = (X @ rng.randn(10, 4)).argmax(1)
    p = tmp_path / "d.csv"
    with open(p, "w") as f:
        for i in range(n):
            f.write(",".join([str(yv[i])] + ["%.6f" % v for v in X[i]])
                    + "\n")
    return str(p), X, yv


def test_c_abi_iterator(lib, tmp_path):
    """``tests/test_cwrapper.py``'s iterator sequence: the batches, a
    net trained two rounds from the iterator handle and its eval line,
    each the port's ``DataIter`` / ``Net`` values."""
    path, X, yv = _csv(tmp_path)
    cfg = ("iter = csv\nfilename = %s\ninput_shape = 1,1,10\n"
           "label_width = 1\niter = end\nbatch_size = 8\n" % path)
    it = lib.CXNIOCreateFromConfig(cfg.encode())
    assert it, lib.CXNGetLastError()
    it = ctypes.c_void_p(it)
    n = 0
    while lib.CXNIONext(it):
        n += 1
    assert n == 4
    lib.CXNIOBeforeFirst(it)
    assert lib.CXNIONext(it)
    oshape, stride = _shape4(), ctypes.c_uint()
    d = lib.CXNIOGetData(it, oshape, ctypes.byref(stride))
    assert tuple(oshape) == (8, 1, 1, 10) and stride.value == 10
    pit = DataIter(cfg)
    assert pit.next()
    np.testing.assert_array_equal(_arr(d, (8, 1, 1, 10)), pit.get_data())
    lshape = (ctypes.c_uint * 2)()
    lab = lib.CXNIOGetLabel(it, lshape, ctypes.byref(stride))
    assert tuple(lshape) == (8, 1) and lab[0] == yv[0]

    net = _CNet(lib, b"cpu")
    lib.CXNNetInitModel(net.h)
    py = Net(dev="cpu", cfg=NET_CFG.decode())
    py.init_model()
    for r in range(2):
        lib.CXNIOBeforeFirst(it)
        while lib.CXNIONext(it):
            lib.CXNNetUpdateIter(net.h, it)
        pit.before_first()
        while pit.next():
            py.update(pit)
    lib.CXNIOBeforeFirst(it)
    assert lib.CXNIONext(it)
    pit.before_first()
    assert pit.next()
    s = lib.CXNNetEvaluate(net.h, it, b"eval")
    assert b"eval-error:" in s
    assert s.decode() == py.evaluate(pit, "eval")
    lib.CXNIOBeforeFirst(it)
    assert lib.CXNIONext(it)
    pit.before_first()
    assert pit.next()
    size = ctypes.c_uint()
    p = lib.CXNNetPredictIter(net.h, it, ctypes.byref(size))
    np.testing.assert_array_equal(_arr(p, (size.value,)), py.predict(pit))
    net.free()
    lib.CXNIOFree(it)
    pit.close()


def test_gpu_device_without_a_card_fails_loudly(lib):
    """Any device but ``"cpu"`` asks for the GPU: here there is none,
    so the create returns NULL with the port's message (no CPU
    fallback)."""
    assert not torch.cuda.is_available()
    for dev in (b"gpu", b"tpu"):
        assert not lib.CXNNetCreate(dev, NET_CFG)
        assert b"no CUDA device" in lib.CXNGetLastError()


C_PROGRAM = r"""
#include "cxxnet_wrapper.h"
#include <stdio.h>

static const char *CFG =
  "netconfig = start\n"
  "layer[0->1] = fullc:fc1\n"
  "  nhidden = 16\n"
  "layer[1->2] = relu\n"
  "layer[2->3] = fullc:fc2\n"
  "  nhidden = 4\n"
  "layer[3->3] = softmax\n"
  "netconfig = end\n"
  "input_shape = 1,1,10\n"
  "batch_size = 8\n"
  "eta = 0.2\n"
  "metric = error\n";

int main(int argc, char **argv) {
  void *net = CXNNetCreate(argc > 1 ? argv[1] : "gpu", CFG);
  if (!net) { fprintf(stderr, "create: %s\n", CXNGetLastError()); return 1; }
  CXNNetInitModel(net);
  float data[8 * 10];
  float label[8];
  cxn_uint dshape[4] = {8, 1, 1, 10};
  cxn_uint lshape[2] = {8, 1};
  unsigned seed = 7;
  for (int i = 0; i < 8 * 10; ++i) {
    seed = seed * 1103515245u + 12345u;
    data[i] = (float)(seed % 1000) / 1000.0f;
  }
  for (int i = 0; i < 8; ++i) label[i] = (float)(i % 4);
  for (int r = 0; r < 3; ++r) {
    CXNNetStartRound(net, r);
    CXNNetUpdateBatch(net, data, dshape, label, lshape);
  }
  cxn_uint osize = 0;
  const cxn_real_t *pred = CXNNetPredictBatch(net, data, dshape, &osize);
  if (!pred || osize != 8) {
    fprintf(stderr, "predict: %s\n", CXNGetLastError());
    return 2;
  }
  for (cxn_uint i = 0; i < osize; ++i) {
    if (pred[i] < 0 || pred[i] > 3) return 3;
  }
  printf("C-ABI-OK preds=");
  for (cxn_uint i = 0; i < osize; ++i) printf("%d", (int)pred[i]);
  printf("\n");
  CXNNetFree(net);
  return 0;
}
"""


def _host_env():
    return dict(os.environ, OMP_NUM_THREADS="1")


def test_standalone_c_program(tmp_path):
    """The embedding path: a C program that owns the interpreter, linked
    against the library, trains and predicts on ``"cpu"``; on a GPU name
    it fails with the port's message."""
    so = capi.build_library()
    src = tmp_path / "host.c"
    src.write_text(C_PROGRAM)
    exe = str(tmp_path / "host")
    subprocess.run(["gcc", str(src), "-I", capi.CAPI_DIR,
                    "-L", capi.BUILD_DIR, "-Wl,-rpath," + capi.BUILD_DIR,
                    "-lcxxnet_wrapper", "-o", exe], check=True)
    out = subprocess.run([exe, "cpu"], capture_output=True, text=True,
                         timeout=300, env=_host_env(), cwd=str(tmp_path))
    assert out.returncode == 0, (out.stdout, out.stderr)
    m = re.search(r"C-ABI-OK preds=(\d{8})", out.stdout)
    assert m, out.stdout
    gpu = subprocess.run([exe, "gpu"], capture_output=True, text=True,
                         timeout=300, env=_host_env(), cwd=str(tmp_path))
    assert gpu.returncode == 1
    assert "no CUDA device" in gpu.stderr
    assert os.path.exists(so)


# the binary's own CXNNetCreate comes before the library's in symbol
# lookup; it forwards to the next definition, the library's, on "cpu"
MEX_CPU_SHIM = r"""
#include <dlfcn.h>
#include <stdio.h>

extern "C" void *CXNNetCreate(const char *device, const char *cfg) {
  typedef void *(*create_fn)(const char *, const char *);
  create_fn next = (create_fn)dlsym(RTLD_NEXT, "CXNNetCreate");
  fprintf(stderr, "CPU-SHIM %s\n", device);
  return next("cpu", cfg);
}
"""


def test_matlab_mex_driver_links_unchanged(tmp_path):
    """``wrapper/matlab/mex_driver.cc`` + ``cxxnet_mex.cpp`` + the stub,
    unchanged, linked with ``-lcxxnet_wrapper`` against the port's
    library: the example.m and example_conv.m flows. The driver names
    ``"tpu"``; a ``CXNNetCreate`` of the test's own, linked into the
    binary, forwards it to the library's with ``"cpu"``."""
    capi.build_library()
    m = os.path.join(REPO, "wrapper", "matlab")
    shim = tmp_path / "cpu_shim.cc"
    shim.write_text(MEX_CPU_SHIM)
    exe = str(tmp_path / "mex_driver")
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-Wall",
         "-I" + os.path.join(m, "mex_stub"), "-o", exe,
         os.path.join(m, "mex_driver.cc"),
         os.path.join(m, "cxxnet_mex.cpp"),
         os.path.join(m, "mex_stub", "mex_stub.cc"), str(shim),
         "-L" + capi.BUILD_DIR, "-Wl,-rpath," + capi.BUILD_DIR,
         "-lcxxnet_wrapper", "-ldl"], check=True)
    csv = tmp_path / "train.csv"
    with open(csv, "w") as f:
        for i in range(32):
            f.write(",".join([str(i % 4)] + ["%.8f" % ((i * 10 + j) / 320.0)
                                             for j in range(10)]) + "\n")
    csv_conv = tmp_path / "train_conv.csv"
    with open(csv_conv, "w") as f:
        for i in range(32):
            f.write(",".join([str(i % 4)] + ["%.8f" % (((i + j) % 36) / 36.0)
                                             for j in range(36)]) + "\n")
    out = subprocess.run([exe, str(csv), str(tmp_path / "m.model"),
                          str(csv_conv), str(tmp_path / "mc.model")],
                         capture_output=True, text=True, timeout=300,
                         env=_host_env())
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "CPU-SHIM tpu" in out.stderr, out.stderr
    assert "MEX-DRIVER-OK" in out.stdout
    assert "MEX-CONV-OK" in out.stdout


def test_build_failure_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    """A failed build raises with g++'s output; no other library is
    loaded in its place."""
    monkeypatch.setattr(capi, "BUILD_DIR", str(tmp_path))
    real = capi.compile_command
    monkeypatch.setattr(capi, "compile_command",
                        lambda out: real(out) + ["-DCXN_NO_SUCH_FLAG",
                                                 "-include",
                                                 "no_such_header.h"])
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        capi.build_library()
    assert not os.path.exists(os.path.join(str(tmp_path), capi.LIB_NAME))
