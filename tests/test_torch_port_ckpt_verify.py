"""``python -m cxxnet_tpu_torch.tools.ckpt_verify`` against the
reference's ``tools/ckpt_verify.py``: the cases of the reference's own
tool tests (``test_checkpoint.py::test_ckpt_verify_tool``, the tool part
of ``test_scan_snapshots_is_read_only_for_inflight_tmp``,
``test_artifact.py::test_ckpt_verify_bundle_tamper_matrix`` and
``test_retrieval.py``'s two index cases) run through both tools on the
same files, which must print the same report and exit with the same
code."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tools.ckpt_verify as ref_cv
from cxxnet_tpu.artifact import bundle as rb
from cxxnet_tpu.parallel import make_mesh
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.serve import build_engine as ref_build_engine
from cxxnet_tpu.utils.config import parse_config as ref_parse
from cxxnet_tpu.utils.faultfs import FaultFS as RefFaultFS
from cxxnet_tpu_torch.artifact import bundle as pb
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.tools import ckpt_verify as port_cv
from cxxnet_tpu_torch.utils.config import parse_config
from cxxnet_tpu_torch.utils.faultfs import FaultFS
from cxxnet_tpu_torch.utils.stream import open_stream
from tests.test_trainer import synth_idx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MLP = """
netconfig=start
layer[+1:h] = fullc:fc1
  nhidden = 8
  init_sigma = 0.1
layer[+1] = relu
layer[h->o] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 16
eta = 0.1
"""
# test_torch_port_bundle.py's conv net: its reference export seals
# programs (prog-0000.pkl)
CONV = """
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
  no_bias = 1
layer[1->2] = batch_norm:bn1
layer[2->3] = relu
layer[3->4] = max_pooling
  kernel_size = 2
  stride = 2
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 4
layer[6->6] = softmax
netconfig=end
input_shape = 3,8,8
batch_size = 4
bn_fold_eval = 1
bn_fuse_relu = 1
conv_pallas_epilogue = 1
serve_buckets = 1,4
"""
INDEX_MEMBER = "index.embed.npz"


def both(capsys, args):
    """Both tools on ``args``: the same exit code and report; returns
    (code, report)."""
    runs = []
    for tool in (ref_cv, port_cv):
        rc = tool.main(list(args))
        runs.append((rc, capsys.readouterr().out))
    assert runs[0] == runs[1], runs
    return runs[1]


@pytest.fixture
def faultfs():
    """Both packages' ``fault://`` schemes over one store; faults are
    set on the port's, whose trainer writes."""
    rfs = RefFaultFS("fault").install()
    pfs = FaultFS("fault").install()
    pfs.store = rfs.store
    try:
        yield pfs
    finally:
        pfs.uninstall()
        rfs.uninstall()


def _trained(seed=0):
    t = NetTrainer(parse_config(MLP) + [("seed", str(seed))], device="cpu")
    t.init_model()
    rng = np.random.RandomState(seed)
    t.update(DataBatch(rng.rand(16, 64).astype(np.float32),
                       rng.randint(0, 4, (16, 1)).astype(np.float32)))
    return t


def _corrupt_array(path):
    """test_checkpoint.py's: one parameter value moved, the digest
    left as it was."""
    blob = dict(np.load(path, allow_pickle=False))
    key = sorted(k for k in blob if k.startswith("param/"))[0]
    arr = np.array(blob[key])
    arr.flat[0] += 1.0
    blob[key] = arr
    with open(path, "wb") as f:
        np.savez(f, **blob)


def test_ckpt_verify_tool(tmp_path, faultfs, capsys):
    t = _trained()
    mdir = str(tmp_path / "m")
    t.save_model(os.path.join(mdir, "0001.model.npz"))
    t.save_model(os.path.join(mdir, "0002.model.npz"))
    rc, out = both(capsys, [mdir])
    assert rc == 0 and out.count("OK") == 2 and "0 corrupt" in out
    _corrupt_array(os.path.join(mdir, "0002.model.npz"))
    rc, out = both(capsys, [mdir])
    assert rc == 1 and "digest mismatch" in out and "1 corrupt" in out
    assert both(capsys, [os.path.join(mdir, "0001.model.npz")])[0] == 0
    # remote: committed-good passes, manifest-less payload is reported
    # as uncommitted, not corruption
    t.save_model("fault://v/0001.model.npz")
    del faultfs.store["fault://v/0001.model.npz.ok"]
    t.save_model("fault://v/0002.model.npz")
    rc, out = both(capsys, ["fault://v"])
    assert rc == 0 and "UNCOMMITTED" in out
    faultfs.truncate_tail = 512
    t.save_model("fault://v/0003.model.npz")
    faultfs.clear_faults()
    assert both(capsys, ["fault://v"])[0] == 1
    # a missing remote snapshot URI is an unreadable FILE (exit 1)
    rc, out = both(capsys, ["fault://v/0099.model.npz"])
    assert rc == 1 and "CORRUPT" in out
    # an empty dir is no corruption; a usage error exits 2
    os.makedirs(str(tmp_path / "empty"))
    rc, out = both(capsys, [str(tmp_path / "empty")])
    assert rc == 0 and "EMPTY" in out
    for tool in (ref_cv, port_cv):
        with pytest.raises(SystemExit) as e:
            tool.main([])
        assert e.value.code == 2


def test_ckpt_verify_never_sweeps_an_inflight_tmp(tmp_path, capsys):
    mdir = str(tmp_path / "m")
    _trained().save_model(os.path.join(mdir, "0001.model.npz"))
    tmp = os.path.join(mdir, "0002.model.npz.tmp")
    with open(tmp, "wb") as f:
        f.write(b"in-flight")
    assert both(capsys, [mdir, "--quiet"]) == (0, "")
    assert os.path.exists(tmp)
    with open(tmp, "rb") as f:
        assert f.read() == b"in-flight"


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A reference bundle that seals programs, beside its snapshot."""
    d = tmp_path_factory.mktemp("ckpt_bundle")
    snap = str(d / "0001.model.npz")
    cfg = ref_parse(CONV)
    t = RefTrainer(cfg, mesh=make_mesh(1, 1))
    t.init_model()
    t.save_model(snap)
    engine = ref_build_engine(cfg, snap, buckets=(1, 4), max_batch=4)
    engine.warmup(warm_run=False)
    bundle = str(d / "0001.model.bundle")
    assert rb.export_bundle(engine, bundle)["programs"] > 0
    return d, snap, bundle


def _put(path, data):
    with open(path, "wb") as f:
        f.write(data)


def _rewritten(path, data):
    """Write ``data`` over ``path``; returns its old bytes."""
    with open(path, "rb") as f:
        orig = f.read()
    _put(path, data)
    return orig


def test_ckpt_verify_bundle_tamper_matrix(exported, capsys):
    d, snap, bundle = exported
    assert both(capsys, [bundle])[0] == 0
    rc, out = both(capsys, [str(d)])
    assert rc == 0 and "(bundle, format v1" in out
    prog = os.path.join(bundle, "prog-0000.pkl")
    with open(prog, "rb") as f:
        data = f.read()
    orig = _rewritten(prog, data[:-32] + b"\0" * 32)
    try:
        rc, out = both(capsys, [bundle])
        assert rc == 1 and "sha256" in out
        assert both(capsys, [str(d)])[0] == 1
    finally:
        _rewritten(prog, orig)
    sp = os.path.join(bundle, rb.SNAPSHOT_MEMBER)
    with open(sp, "rb") as f:
        data = f.read()
    orig = _rewritten(sp, data[:-8])
    try:
        assert both(capsys, [bundle])[0] == 1
    finally:
        _rewritten(sp, orig)
    okp = os.path.join(bundle, rb.MANIFEST_NAME + rb.OK_SUFFIX)
    orig = _rewritten(okp, b"[]")
    try:
        rc, out = both(capsys, [bundle])
        assert rc == 1 and "not a JSON object" in out
    finally:
        _rewritten(okp, orig)
    # uncommitted: an explicit target fails; a dir scan reports, skips
    os.rename(okp, okp + ".bak")
    try:
        rc, out = both(capsys, [bundle])
        assert rc == 1 and "uncommitted" in out
        rc, out = both(capsys, [str(d)])
        assert rc == 0 and "UNCOMMITTED" in out
    finally:
        os.rename(okp + ".bak", okp)
    assert both(capsys, [bundle])[0] == 0


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """The port's ``task = build_index`` bundle (an index member) of an
    MLP snapshot, on the CPU."""
    d = tmp_path_factory.mktemp("ckpt_index")
    pimg, plab = synth_idx(str(d), n=80, d=8, name="retr")
    conf = str(d / "run.conf")
    with open(conf, "w") as f:
        f.write('data = train\niter = mnist\n  path_img = "%s"\n'
                '  path_label = "%s"\n  silent = 1\niter = end\n%s\n'
                'print_step = 0\n' % (pimg, plab, MLP))
    snap = str(d / "0001.model.npz")
    _trained().save_model(snap)
    bundle = str(d / "0001.model.bundle")
    assert LearnTask().run([conf, "dev=cpu", "model_in=" + snap,
                            "export_out=" + bundle, "task=build_index",
                            "index_metric=cosine", "index_rows=48",
                            "search_k=4", "search_buckets=1,4"]) == 0
    assert pb.bundle_manifest(bundle)["index"]["member"] == INDEX_MEMBER
    return bundle


def test_ckpt_verify_flags_missing_and_torn_index(indexed, capsys):
    bundle = indexed
    assert both(capsys, [bundle])[0] == 0
    member = os.path.join(bundle, INDEX_MEMBER)
    with open(member, "rb") as f:
        data = f.read()
    orig = _rewritten(member, data[:-32])
    try:
        rc, out = both(capsys, [bundle])
        assert rc == 1 and "CORRUPT" in out
    finally:
        _rewritten(member, orig)
    os.remove(member)
    try:
        assert both(capsys, [bundle])[0] == 1
    finally:
        _put(member, orig)
    man_path = os.path.join(bundle, pb.MANIFEST_NAME)
    with open(man_path) as f:
        man = json.load(f)
    man["index"]["member"] = "ghost.npz"
    orig = _rewritten(man_path, json.dumps(man).encode())
    try:
        assert both(capsys, [bundle])[0] == 1
    finally:
        _rewritten(man_path, orig)
    assert both(capsys, [bundle])[0] == 0


def test_ckpt_verify_torn_index_via_faultfs(indexed, faultfs, capsys):
    remote = "fault://store/0001.model.bundle"
    names = sorted(os.listdir(indexed),
                   key=lambda n: n.endswith(pb.OK_SUFFIX))
    for name in names:
        with open(os.path.join(indexed, name), "rb") as f:
            data = f.read()
        with open_stream("%s/%s" % (remote, name), "wb") as f:
            f.write(data)
    assert both(capsys, [remote])[0] == 0
    victim = "%s/%s" % (remote, INDEX_MEMBER)
    data = faultfs.store[victim]
    faultfs.truncate_tail = 48
    with open_stream(victim, "wb") as f:
        f.write(data)
    faultfs.clear_faults()
    rc, out = both(capsys, [remote])
    assert rc == 1 and "CORRUPT" in out and INDEX_MEMBER in out


def test_ckpt_verify_runs_as_a_module(tmp_path):
    """``python -m cxxnet_tpu_torch.tools.ckpt_verify``: its exit code
    is main's."""
    _trained().save_model(str(tmp_path / "0001.model.npz"))
    p = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.ckpt_verify",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert "checked 1 snapshot(s), 0 corrupt" in p.stdout
