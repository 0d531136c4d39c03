"""``example/ImageNet/AlexNet.conf`` through both CLIs, narrowed.

The test writes a copy of the shipped conf with every layer type, group
count, pad and stride kept and the widths cut: conv channels to an
eighth (96, 256, 384 -> 12, 32, 48), fc6 and fc7 to 64, 10 classes,
batch 4 at the conf's 227 crop, and the dropout threshold 0 (the
packages' dropout draws differ; ROADMAP, "How parity is held"). Its data
paths point at seeded raw-tensor imgrec archives (12 train records of
256x256x3 uint8, three batches a round, and 4 validation records);
``rand_crop`` and ``rand_mirror`` draw from the same numpy stream in
both packages, so both see the same batches.

Both CLIs train one round from one reference snapshot (``0000``), with
``dev = cpu``. The reference's CLI runs as the port does: its trainers
on one device (the test session's 8 virtual CPU devices would shard the
batch and sum the gradients in another order) and their steps compiled
with XLA's ``xla_allow_excess_precision`` off (every bf16 op rounds;
with it on, the default, XLA keeps float32 inside a fusion where
PyTorch rounds, and three bf16 updates then lie 18 % apart). Each
parameter's update (``0001`` less ``0000``) is held against the
reference's as ||d_port - d_ref|| / ||d_ref||:

- float32 (``dtype = float32`` on the command line): every parameter
  within 2e-5 (2.6e-6 measured: convolutions and products sum in
  another order);
- the conf's ``dtype = bfloat16``: every parameter within 2e-3 and the
  whole update within 1e-4 (1.5e-4 and 8.5e-6 measured; the first
  update is the same bits, then a last-bit float32 difference of a
  weight gradient now and then rounds a bf16 weight shadow the other
  way: conv1's weight takes the largest share).

The round lines agree to their printed digits, and ``task = pred`` from
the reference's snapshot writes the same classes, in both dtypes.
"""

import os
import re

import numpy as np
import pytest
import torch

from cxxnet_tpu import parallel as ref_parallel
from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.nnet.checkpoint import read_snapshot as ref_read_snapshot
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.utils.config import parse_config_file
from cxxnet_tpu_torch.io import recordio
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot
from test_torch_port_bf16 import _PerOpRounding
from test_torch_port_main import run_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "example", "ImageNet", "AlexNet.conf")
NCLASS, TRAIN_RECORDS, VAL_RECORDS = 10, 12, 4
# (text in the shipped conf, its replacement, how often it occurs)
NARROW = (("nchannel = 96\n", "nchannel = 12\n", 1),
          ("nchannel = 256\n", "nchannel = 32\n", 2),
          ("nchannel = 384\n", "nchannel = 48\n", 2),
          ("nhidden = 4096\n", "nhidden = 64\n", 2),
          ("nhidden = 1000\n", "nhidden = %d\n" % NCLASS, 1),
          ("threshold = 0.5\n", "threshold = 0\n", 2),
          ("batch_size = 256\n", "batch_size = 4\n", 1),
          ("path_imgrec = train.rec\n", "path_imgrec = train.rec\n", 1),
          ("path_imgrec = val.rec\n", "path_imgrec = val.rec\n", 1),
          ("dtype = bfloat16\n", "dtype = bfloat16\n", 1))
F32_UPDATE_RTOL = 2e-5
BF16_UPDATE_WHOLE, BF16_UPDATE_ARRAY = 1e-4, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _archive(path, n, rng):
    """Seeded 256x256x3 uint8 records about the conf's mean_value with
    a spread of 24 (uniform pixels over 0-255 make the narrowed net's
    first updates diverge, where any rounding difference grows without
    bound)."""
    w = recordio.RecordIOWriter(path)
    for i in range(n):
        img = np.clip(np.array([123, 117, 104]) + 24 * rng.randn(
            256, 256, 3), 0, 255).astype(np.uint8)
        w.write_record(recordio.pack_raw_tensor_record(
            i, float(rng.randint(NCLASS)), img))
    w.close()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The narrowed conf, the archives and the reference's snapshot
    ``ref/0000.model.npz`` (its initialization at the conf's seed)."""
    d = tmp_path_factory.mktemp("alexnet")
    rng = np.random.RandomState(0)
    _archive(str(d / "train.rec"), TRAIN_RECORDS, rng)
    _archive(str(d / "val.rec"), VAL_RECORDS, rng)
    with open(CONF) as f:
        text = f.read()
    for old, new, count in NARROW:
        assert text.count(old) == count, old
        text = text.replace(old, new)
    conf = str(d / "AlexNet.conf")
    with open(conf, "w") as f:
        f.write(text)
    os.makedirs(str(d / "ref"))
    t = RefTrainer(parse_config_file(conf))
    t.init_model()
    t.save_model(str(d / "ref" / "0000.model.npz"))
    return {"dir": d, "conf": conf, "model": str(d / "ref" / "0000.model.npz")}


def _as_the_port_runs(mp):
    """The reference CLI's trainers on one device (not the batch sharded
    over the test session's virtual CPU devices), their steps compiled
    with excess precision off (every bf16 op rounds, as the port's eager
    ops do)."""
    mp.setattr(ref_parallel, "default_data_axis", lambda *a, **k: 1)
    build = RefTrainer._build_steps

    def _build_steps(self):
        build(self)
        for name in ("_train_step", "_many_step", "_pred_step"):
            setattr(self, name, _PerOpRounding(getattr(self, name)))
    mp.setattr(RefTrainer, "_build_steps", _build_steps)


def _both(env, *overrides):
    old = os.getcwd()
    os.chdir(str(env["dir"]))
    try:
        res = []
        for pkg, cls in (("ref", RefTask), ("port", LearnTask)):
            argv = [env["conf"], "dev=cpu"] + \
                [o.format(pkg=pkg) for o in overrides]
            with pytest.MonkeyPatch.context() as mp:
                _as_the_port_runs(mp)
                rc, out = run_cli(cls, argv)
            assert rc == 0, out
            res.append(out)
    finally:
        os.chdir(old)
    return res


def _round_lines(out):
    return [ln for ln in out.splitlines() if re.match(r"^\[\d+\]", ln)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_alexnet_conf_trains_a_round_like_the_reference(env, dtype):
    tag = dtype[:4]
    ref_out, port_out = _both(
        env, "task=train", "model_in=" + env["model"], "num_round=1",
        "save_model=1", "model_dir={pkg}_%s" % tag, "dtype=" + dtype)
    ref_a, ref_m = ref_read_snapshot(
        str(env["dir"] / ("ref_%s" % tag) / "0001.model.npz"))
    port_a, port_m = read_snapshot(
        str(env["dir"] / ("port_%s" % tag) / "0001.model.npz"))
    assert port_m["update_counter"] == ref_m["update_counter"] == 3
    keys = sorted(k for k in ref_a if not k.startswith("__"))
    assert keys == sorted(k for k in port_a if not k.startswith("__"))
    assert any(k.startswith("param/conv2/") for k in keys)
    base, _ = ref_read_snapshot(env["model"])
    rel = {}
    for k in keys:
        d_ref = ref_a[k].astype(np.float64) - base[k]
        d_port = port_a[k].astype(np.float64) - base[k]
        rel[k] = float(np.linalg.norm(d_port - d_ref)
                       / np.linalg.norm(d_ref))
    whole = float(np.sqrt(
        sum(np.sum((port_a[k].astype(np.float64) - ref_a[k]) ** 2)
            for k in keys)
        / sum(np.sum((ref_a[k].astype(np.float64) - base[k]) ** 2)
              for k in keys)))
    assert _round_lines(port_out) == _round_lines(ref_out)
    if dtype == "float32":
        assert max(rel.values()) <= F32_UPDATE_RTOL, rel
    else:
        assert whole <= BF16_UPDATE_WHOLE, (whole, rel)
        assert max(rel.values()) <= BF16_UPDATE_ARRAY, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_alexnet_conf_pred_from_reference_snapshot(env, dtype):
    """``task = pred`` over the val archive from the reference's
    snapshot: the same classes in both packages."""
    _both(env, "task=pred", "model_in=" + env["model"], "dtype=" + dtype,
          "pred={pkg}.pred.txt", "iter=imgrec",
          "path_imgrec=" + str(env["dir"] / "val.rec"),
          "input_shape=3,227,227", "iter=end")
    with open(str(env["dir"] / "ref.pred.txt")) as a, \
            open(str(env["dir"] / "port.pred.txt")) as b:
        ref, port = a.read(), b.read()
    assert port == ref and len(ref.splitlines()) == VAL_RECORDS
