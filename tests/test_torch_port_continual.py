"""The port's continual loop (``cxxnet_tpu_torch/continual``) against the
reference's (``cxxnet_tpu/continual``).

The reference's own continual runs fail in this container (its bundle
boot: ROADMAP queue 3, "A note on the oracle itself"), so the loop is
held against the reference's snapshot flow:

- ``ContinualConfig`` raises, passes and ratchets alike in both
  packages, ``continual_index_rows`` included (a retrieval corpus:
  ``tests/test_torch_port_build_index.py`` runs it);
- a reduced MNIST MLP (784-32-10) on the first 600 / 200 tracked digits,
  ``shuffle = 0``, runs ``task = continual`` with ``continual_task =
  finetune`` from a reference snapshot, 6 updates a generation: each
  deployed generation's bundle snapshot holds every parameter within
  rtol 1e-5 / atol 1e-6 of the reference's ``task = train`` snapshot
  after the same number of updates (the reference on one device, so
  the sums run in one order), and each gate decision is the one the
  reference's ``ContinualConfig`` takes on the port's own eval values;
- ``example/MNIST/MNIST_CONTINUAL.conf`` as shipped runs through
  ``python -m cxxnet_tpu_torch.main`` on the CPU (ports 0, no linger,
  a small ``continual_export_every``) and exits 0.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from cxxnet_tpu.continual import ContinualConfig as RefConfig
from cxxnet_tpu.continual import ContinualLoop as RefLoop
from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.parallel import make_mesh
from cxxnet_tpu.utils.config import parse_config
from cxxnet_tpu_torch.artifact import bundle as pb
from cxxnet_tpu_torch.continual import ContinualConfig, ContinualLoop
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot
from cxxnet_tpu_torch.nnet.trainer import NetTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGITS = os.path.join(ROOT, "example", "MNIST", "data")
RTOL, ATOL = 1e-5, 1e-6
NTRAIN, NTEST, BATCH = 600, 200, 100
EVERY = NTRAIN // BATCH                  # one epoch a generation

CONF = """data = train
iter = mnist
  path_img = "tr-img"
  path_label = "tr-lab"
  shuffle = 0
  silent = 1
iter = end
eval = test
iter = mnist
  path_img = "te-img"
  path_label = "te-lab"
  silent = 1
iter = end
netconfig = start
layer[+1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.01
layer[+1] = relu:ac1
layer[+1] = fullc:fc2
  nhidden = 10
  init_sigma = 0.01
layer[+0] = softmax
netconfig = end
input_shape = 1,1,784
batch_size = 100
eta = 0.1
momentum = 0.9
wd = 0.0
metric = error
print_step = 0
silent = 1
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- ContinualConfig ------------------------------------------------------

CONFIG_CASES = [
    [("continual_generations", "3")],
    [("continual_export_every", "5"), ("continual_gate", "sideways")],
    [("continual_export_every", "5"), ("continual_task", "serve")],
    [("continual_export_every", "0")],
    [("continual_export_every", "5"), ("continual_generations", "0")],
    [("continual_export_every", "x")],
    [("continual_export_every", "5"), ("continual_gate", "max"),
     ("continual_gate_eps", "0.1")],
    [("continual_export_every", "7"), ("continual_task", "finetune"),
     ("continual_gate", "off"), ("continual_eval", "test"),
     ("continual_metric", "error"), ("continual_swap_timeout_s", "3"),
     ("continual_linger_s", "0.5"), ("continual_max_updates", "40")],
]
FIELDS = ("generations", "export_every", "task", "eval_name", "metric",
          "gate", "gate_eps", "swap_timeout_s", "linger_s", "max_updates")


def _parse(cls, cfg):
    try:
        c = cls(cfg)
    except ValueError as e:
        return ("ValueError", str(e))
    return tuple(getattr(c, f) for f in FIELDS)


@pytest.mark.parametrize("i", range(len(CONFIG_CASES)))
def test_continual_config_alike(i):
    cfg = CONFIG_CASES[i]
    assert _parse(ContinualConfig, cfg) == _parse(RefConfig, cfg)


@pytest.mark.parametrize("gate", ["min", "max", "off"])
def test_gate_passes_and_ratchets_alike(gate):
    cfg = [("continual_export_every", "5"), ("continual_gate", gate),
           ("continual_gate_eps", "0.05")]
    p, r = ContinualConfig(cfg), RefConfig(cfg)
    for value in (0.1, 0.3, 0.34, 0.36, 0.5):
        for best in (None, 0.3):
            assert p.passes(value, best) == r.passes(value, best)
            assert p.ratchet(value, best) == r.ratchet(value, best)


def test_index_rows_raise_not_ported():
    """continual_index_rows is ported: both packages read it alike and
    neither raises."""
    cfg = [("continual_export_every", "5"), ("continual_index_rows", "16")]
    p, r = ContinualConfig(cfg), RefConfig(cfg)
    assert p.index_rows == r.index_rows == 16


def test_gate_needs_an_eval_block(tmp_path):
    cfg = parse_config(CONF) + [("continual_export_every", "5")]
    for loop, trainer in ((RefLoop, RefTrainer(cfg)),
                          (ContinualLoop, NetTrainer(cfg, device="cpu"))):
        with pytest.raises(ValueError, match="eval"):
            loop(cfg, trainer, itr_train=object(), eval_iters=[],
                 model_dir=str(tmp_path),
                 path_for=lambda c: str(tmp_path / str(c)))


# -- the loop against the reference's snapshot flow -----------------------


def _idx_subset(src_img, src_lab, dst_img, dst_lab, n):
    """The first ``n`` digits of an idx pair."""
    with open(src_img, "rb") as f:
        _, _, rows, cols = struct.unpack(">iiii", f.read(16))
        img = f.read(n * rows * cols)
    with open(dst_img, "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, rows, cols) + img)
    with open(src_lab, "rb") as f:
        f.read(8)
        lab = f.read(n)
    with open(dst_lab, "wb") as f:
        f.write(struct.pack(">ii", 2049, n) + lab)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's init snapshot, its task = train snapshots after
    1-4 epochs (one device), and the port's continual run from it."""
    d = tmp_path_factory.mktemp("continual")
    _idx_subset(os.path.join(DIGITS, "train-images-idx3-ubyte"),
                os.path.join(DIGITS, "train-labels-idx1-ubyte"),
                str(d / "tr-img"), str(d / "tr-lab"), NTRAIN)
    _idx_subset(os.path.join(DIGITS, "t10k-images-idx3-ubyte"),
                os.path.join(DIGITS, "t10k-labels-idx1-ubyte"),
                str(d / "te-img"), str(d / "te-lab"), NTEST)
    with open(str(d / "c.conf"), "w") as f:
        f.write(CONF)
    cwd = os.getcwd()
    os.chdir(str(d))
    try:
        t = RefTrainer(parse_config(CONF), mesh=make_mesh(1, 1))
        t.init_model()
        t.save_model("init.npz")
        import cxxnet_tpu.parallel as rpar
        axis = rpar.default_data_axis
        rpar.default_data_axis = lambda batch: 1
        try:
            assert RefTask().run(["c.conf", "task=train",
                                  "model_in=init.npz", "model_dir=ref",
                                  "num_round=4"]) == 0
        finally:
            rpar.default_data_axis = axis
        rc = LearnTask().run([
            "c.conf", "dev=cpu", "task=continual", "model_in=init.npz",
            "model_dir=port", "continual_task=finetune",
            "continual_export_every=%d" % EVERY,
            "continual_generations=2",
            "continual_max_updates=%d" % (4 * EVERY),
            "dispatch_period=3", "serve_buckets=1,8",
            "serve_max_batch=8", "serve_http_port=0",
            "serve_binary_port=-1", "monitor=jsonl",
            "monitor_path=port.jsonl"])
        assert rc == 0
    finally:
        os.chdir(cwd)
    return d


def test_generations_match_reference_train_snapshots(runs):
    recs = read_jsonl(str(runs / "port.jsonl"))
    assert validate_records(recs, strict=False) == []
    gens = [r for r in recs if r["event"] == "generation"]
    deployed = [r for r in gens if r["action"] == "deployed"]
    assert len(deployed) == 2
    for r in deployed:
        assert r["train_updates"] % EVERY == 0
        rnd = r["train_updates"] // EVERY
        path = os.path.join(str(runs), r["path"])   # model_dir=port
        got, _ = read_snapshot(os.path.join(path, pb.SNAPSHOT_MEMBER))
        want, _ = read_snapshot(str(runs / "ref" / ("%04d.model.npz"
                                                    % rnd)))
        keys = sorted(k for k in want if k.startswith("param/"))
        assert keys and keys == sorted(k for k in got
                                       if k.startswith("param/"))
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        assert pb.verify_bundle(path)["ok"]


def test_gate_decisions_are_the_references(runs):
    recs = read_jsonl(str(runs / "port.jsonl"))
    cfg = parse_config(CONF) + [("continual_export_every", str(EVERY))]
    cc = RefConfig(cfg)
    best = None
    gens = [r for r in recs if r["event"] == "generation"]
    assert gens and all(r["metric"] == "error" for r in gens)
    for r in gens:
        want = "deployed" if cc.passes(r["value"], best) \
            else "gate_skipped"
        assert r["action"] == want
        assert r["gate_best"] == best
        if want == "deployed":
            best = cc.ratchet(r["value"], best)
    (roll,) = [r for r in recs if r["event"] == "continual"]
    assert roll["deployed"] == 2 and roll["swaps"] == 1
    assert roll["gate_skipped"] == len(gens) - 2
    # the export of generation 2 reloaded the first engine in place
    assert [r["export_engine_built"] for r in gens
            if r["action"] == "deployed"] == [True, False]


def test_mnist_continual_conf_runs_through_the_cli(tmp_path):
    """The shipped config, with the ports and generations the chip phase
    uses and a small continual_export_every, exits 0 and deploys every
    generation it runs."""
    os.symlink(DIGITS, str(tmp_path / "data"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p))
    p = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.main",
         os.path.join(ROOT, "example", "MNIST", "MNIST_CONTINUAL.conf"),
         "dev=cpu", "serve_http_port=0", "serve_binary_port=0",
         "continual_linger_s=0", "continual_generations=3",
         "continual_export_every=16", "dispatch_period=8"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "continual: 3 generation(s) deployed" in p.stdout
    recs = read_jsonl(str(tmp_path / "mnist_continual.jsonl"))
    assert validate_records(recs, strict=False) == []
    gens = [r for r in recs if r["event"] == "generation"]
    assert [r["action"] for r in gens].count("deployed") == 3
    for c in (1, 2, 3):
        assert os.path.isdir(str(tmp_path / "models"
                                 / ("%04d.model.bundle" % c)))
    assert json.loads(json.dumps(gens[0]))["metric"] == "error"
