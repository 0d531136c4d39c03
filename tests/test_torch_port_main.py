"""The port's CLI (``python -m cxxnet_tpu_torch.main``) against the
reference's (``python -m cxxnet_tpu.main``), both run in process with
``dev = cpu``, from one snapshot the reference's CLI writes.

Two configurations: a small CSV MLP (the verify recipe: 200 rows of 10
features, 4 classes, batch 20, so a round is one ``update_many`` window
of ``dispatch_period = 8`` batches and a tail of 2 per-batch updates)
and ``example/MNIST/MNIST.conf`` over 400 / 200 seeded idx rows (4
batches of 100: the round tail carries the whole round; no ``pred``
block, so the pred-like tasks fall back to the shuffled train block).

Tolerances: ``pred`` and ``get_weight`` files are identical; ``pred_raw``
and ``extract`` within rtol 1e-5 / atol 1e-6; one round trained from the
reference's snapshot gives every parameter within rtol 1e-4 / atol 1e-6
of the reference's next snapshot (the reference averages gradients over
its 8 virtual CPU devices, the port over one batch, so float32 sums
differ in order), and the printed metric lines agree to their printed
digits.
"""

import contextlib
import io
import json
import os
import re
import shutil
import signal
import struct

import numpy as np
import pytest
import torch

from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.nnet.checkpoint import read_snapshot as ref_read_snapshot
from cxxnet_tpu_torch.main import LearnTask, NOT_PORTED_TASKS
from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot
from cxxnet_tpu_torch.utils.config import NotPortedError, Roadmap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_CONF = os.path.join(ROOT, "example", "MNIST", "MNIST.conf")

CSV_CONF = """data = train
iter = csv
  filename = train.csv
  input_shape = 1,1,10
  label_width = 1
  silent = 1
iter = end
eval = test
iter = csv
  filename = test.csv
  input_shape = 1,1,10
  silent = 1
iter = end
pred = pred.txt
iter = csv
  filename = test.csv
  input_shape = 1,1,10
  silent = 1
iter = end
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig = end
batch_size = 20
eta = 0.3
momentum = 0.9
num_round = 1
metric = error
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops on one thread: at these sizes more threads
    only contend with each other and with the other test workers'."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_cli(task_cls, argv):
    """(rc, stdout) of one in-process CLI run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = task_cls().run(argv)
    return rc, buf.getvalue()


def _csv(path, n, rng):
    x = rng.rand(n, 10).astype(np.float32)
    y = (x @ rng.randn(10, 4)).argmax(1)
    with open(path, "w") as f:
        for i in range(n):
            f.write(",".join([str(y[i])] + ["%.5f" % v for v in x[i]])
                    + "\n")


def _idx(dirname, prefix, n, rng):
    img = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    # a learnable signal: the label's row of pixels is bright
    for i in range(n):
        img[i, 2 * lab[i] + 4, :] = 255
    with open(os.path.join(dirname, "%s-images-idx3-ubyte" % prefix),
              "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28) + img.tobytes())
    with open(os.path.join(dirname, "%s-labels-idx1-ubyte" % prefix),
              "wb") as f:
        f.write(struct.pack(">ii", 2049, n) + lab.tobytes())


@pytest.fixture(scope="module", params=["csv", "mnist"])
def env(request, tmp_path_factory):
    """A working directory with the data, the conf and the reference's
    first snapshot (``ref/0001.model.npz``)."""
    d = tmp_path_factory.mktemp(request.param)
    rng = np.random.RandomState(0)
    if request.param == "csv":
        _csv(str(d / "train.csv"), 200, rng)
        _csv(str(d / "test.csv"), 60, rng)
        conf = str(d / "mlp.conf")
        with open(conf, "w") as f:
            f.write(CSV_CONF)
    else:
        os.mkdir(str(d / "data"))
        _idx(str(d / "data"), "train", 400, rng)
        _idx(str(d / "data"), "t10k", 200, rng)
        conf = MNIST_CONF
    old = os.getcwd()
    os.chdir(str(d))
    try:
        rc, out = run_cli(RefTask, [conf, "dev=cpu", "num_round=1",
                                    "save_model=1", "model_dir=ref"])
    finally:
        os.chdir(old)
    assert rc == 0, out
    return {"kind": request.param, "dir": d, "conf": conf,
            "model": str(d / "ref" / "0001.model.npz")}


def both(env, *overrides):
    """Run the reference's and the port's CLI with the same overrides
    (``{pkg}`` in an override names the package); returns
    ((rc, out), (rc, out))."""
    old = os.getcwd()
    os.chdir(str(env["dir"]))
    try:
        res = []
        for pkg, cls in (("ref", RefTask), ("port", LearnTask)):
            argv = [env["conf"], "dev=cpu"] + \
                [o.format(pkg=pkg) for o in overrides]
            res.append(run_cli(cls, argv))
    finally:
        os.chdir(old)
    for rc, out in res:
        assert rc == 0, out
    return res


def path(env, name):
    return str(env["dir"] / name)


def test_pred_file_identical(env):
    both(env, "task=pred", "model_in=" + env["model"],
         "pred={pkg}.pred.txt")
    with open(path(env, "ref.pred.txt")) as a, \
            open(path(env, "port.pred.txt")) as b:
        ref, port = a.read(), b.read()
    assert port == ref
    assert len(ref.splitlines()) == (60 if env["kind"] == "csv" else 400)


@pytest.mark.parametrize("task,fmt,node", [
    ("pred_raw", "txt", ""), ("extract", "txt", "top[-1]"),
    ("extract", "bin", "top[-1]"), ("extract_feature", "bin", "top")])
def test_extract_within_tolerance(env, task, fmt, node):
    out = "%s.%s.%s" % (task, len(node), fmt)
    args = ["task=" + task, "model_in=" + env["model"],
            "output_format=" + fmt, "pred={pkg}." + out]
    if node:
        args.append("extract_node_name=" + node)
    both(env, *args)
    got = {}
    for pkg in ("ref", "port"):
        p = path(env, "%s.%s" % (pkg, out))
        with open(p + ".meta") as f:
            meta = f.read()
        if fmt == "txt":
            arr = np.loadtxt(p, ndmin=2)
        else:
            n, c, y, x = (int(t) for t in meta.split(","))
            arr = np.fromfile(p, "<f4").reshape(n, c * y * x)
        got[pkg] = (meta, arr)
    assert got["port"][0] == got["ref"][0]
    np.testing.assert_allclose(got["port"][1], got["ref"][1],
                               rtol=1e-5, atol=1e-6)
    if task == "pred_raw":
        np.testing.assert_allclose(got["port"][1].sum(1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("fmt", ["txt", "bin"])
def test_get_weight_identical(env, fmt):
    both(env, "task=get_weight", "model_in=" + env["model"],
         "weight_layer=fc1", "output_format=" + fmt,
         "weight_filename={pkg}.w." + fmt)
    with open(path(env, "ref.w." + fmt), "rb") as a, \
            open(path(env, "port.w." + fmt), "rb") as b:
        assert a.read() == b.read()


def _metric_lines(out):
    return [ln for ln in out.splitlines() if re.match(r"^\[\d+\]", ln)]


def test_train_from_reference_snapshot(env):
    """task = train from 0001: the next snapshot and the printed lines."""
    (_, ref_out), (_, port_out) = both(
        env, "task=train", "model_in=" + env["model"], "num_round=2",
        "save_model=1", "model_dir={pkg}_train", "print_step=1")
    ref_lines, port_lines = _metric_lines(ref_out), _metric_lines(port_out)
    assert len(ref_lines) == 1 and ref_lines[0].startswith("[2]\ttrain-")
    assert port_lines == ref_lines
    # the progress lines (printed after each update_many window: one
    # for the CSV round, none for MNIST's) and the end line, in the
    # reference's format
    prog = r"^(round +1:\[ +\d+\]) \d+ sec elapsed$"
    assert re.findall(prog, port_out, re.M) == \
        re.findall(prog, ref_out, re.M) == \
        (["round        1:[       8]"] if env["kind"] == "csv" else [])
    assert re.search(r"^updating end, \d+ sec in all$", port_out, re.M)
    assert not os.path.exists(path(env, "port_train/0001.model.npz"))
    ref_a, ref_m = ref_read_snapshot(path(env, "ref_train/0002.model.npz"))
    port_a, port_m = read_snapshot(path(env, "port_train/0002.model.npz"))
    assert sorted(port_a) == sorted(ref_a)
    for k in ref_a:
        if k.startswith("__"):
            continue                     # the meta blob, compared below
        np.testing.assert_allclose(port_a[k], ref_a[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert port_m["update_counter"] == ref_m["update_counter"]


def test_test_io_counts_the_same_rows(env):
    (_, ref_out), (_, port_out) = both(env, "test_io=1", "num_round=2")
    pat = r"^test_io: (\d+) instances"
    n_ref = int(re.search(pat, ref_out, re.M).group(1))
    assert int(re.search(pat, port_out, re.M).group(1)) == n_ref
    assert n_ref == (400 if env["kind"] == "csv" else 800)


def test_quantize_passes_the_gate(env):
    (_, ref_out), (_, port_out) = both(
        env, "task=quantize", "model_in=" + env["model"],
        "quantize_out={pkg}.int8.npz")
    pat = r"quantize\[int8\]: (\d+) layers \(0 fallback\) over (\d+) " \
          r"batches, parity mean\|Δ\| (\S+) .* — wrote"
    mr, mp = re.search(pat, ref_out), re.search(pat, port_out)
    assert mr and mp, port_out
    assert mp.group(1) == mr.group(1) == "2"
    assert mp.group(2) == mr.group(2)
    assert float(mp.group(3)) <= 0.05
    arrays, meta = read_snapshot(path(env, "port.int8.npz"))
    assert meta["quantized"]["dtype"] == "int8"
    assert any(k.startswith("quant/") for k in arrays)


def test_serve_soak_has_no_failures(env):
    (_, ref_out), (_, port_out) = both(
        env, "task=serve", "model_in=" + env["model"], "serve_clients=4",
        "serve_requests=6", "serve_request_rows=3", "serve_buckets=1,4,8",
        "serve_max_batch=8")
    pat = r"serve: (\d+) ok / (\d+) busy / (\d+) timeout / (\d+) error " \
          r"requests \((\d+) rows\)"
    for out in (ref_out, port_out):
        m = re.search(pat, out)
        assert m, out
        assert [int(g) for g in m.groups()] == [24, 0, 0, 0, 72]


NOT_PORTED = [("task=" + t, item) for t, item in NOT_PORTED_TASKS.items()] + [
    ("test_on_server=1", Roadmap.MULTI_GPU),
    ("dist_coordinator=localhost:1234", Roadmap.MULTI_GPU),
    ("dist_num_hosts=2", Roadmap.MULTI_GPU),
    ("dist_host_rank=0", Roadmap.MULTI_GPU),
    ("dist_dryrun_hosts=2", Roadmap.MULTI_GPU),
]


@pytest.mark.parametrize("what,item", NOT_PORTED, ids=[w for w, _ in
                                                        NOT_PORTED])
def test_unported_raises_naming_its_item(tmp_path, monkeypatch, what,
                                         item):
    """Each task and key the port does not have raises NotPortedError
    naming its ROADMAP item; none is ignored."""
    rng = np.random.RandomState(1)
    _csv(str(tmp_path / "train.csv"), 40, rng)
    _csv(str(tmp_path / "test.csv"), 20, rng)
    conf = CSV_CONF
    args = ["dev=cpu", "model_dir=m"]
    args.append(what)
    with open(str(tmp_path / "c.conf"), "w") as f:
        f.write(conf)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotPortedError) as e:
        run_cli(LearnTask, ["c.conf"] + args)
    assert e.value.roadmap_item == item


# the telemetry keys that raised NotPortedError before they were ported:
# each now runs, and its record stream passes both packages' schema
MONITOR_KEYS = ["monitor=stdout", "monitor=jsonl", "monitor_trace_dir=trace"]


@pytest.mark.parametrize("what", MONITOR_KEYS)
def test_monitor_keys_run(tmp_path, monkeypatch, what):
    """``monitor = stdout`` and ``jsonl`` train two rounds with a stream
    that validates in both packages' ``validate_records`` (one step
    record per dispatch: 40 rows at batch 20 are two per-batch updates
    a round);
    ``monitor_trace_dir`` under ``monitor = none`` writes the Chrome
    trace of round 1 and no record."""
    from cxxnet_tpu.monitor.schema import validate_records as ref_validate
    from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
    rng = np.random.RandomState(1)
    _csv(str(tmp_path / "train.csv"), 40, rng)
    _csv(str(tmp_path / "test.csv"), 20, rng)
    with open(str(tmp_path / "c.conf"), "w") as f:
        f.write(CSV_CONF)
    monkeypatch.chdir(tmp_path)
    args = ["c.conf", "dev=cpu", "model_dir=m", "num_round=2", what]
    if what == "monitor=jsonl":
        args.append("monitor_path=mon.jsonl")
    rc, out = run_cli(LearnTask, args)
    assert rc == 0, out
    if what == "monitor_trace_dir=trace":
        assert not any(ln.startswith("{") for ln in out.splitlines())
        assert os.listdir("trace") == ["trace_r1-1.json"]
        with open(os.path.join("trace", "trace_r1-1.json")) as f:
            assert json.load(f)["traceEvents"]
        return
    recs = read_jsonl("mon.jsonl") if what == "monitor=jsonl" else [
        json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert validate_records(recs) == [] and ref_validate(recs) == []
    steps = [r for r in recs if r["event"] == "step"]
    assert [s["step"] for s in steps] == [1, 2, 3, 4]
    assert [s["round"] for s in steps] == [0, 0, 1, 1]
    assert sum(s["examples"] for s in steps) == 80
    assert recs[-1]["event"] == "run_end" and recs[-1]["steps"] == 4


# the checkpoint and CLI keys that raised NotPortedError before they were
# ported: each now runs (the fault matrix is tests/test_torch_port_
# checkpoint.py; finetune is tests/test_torch_port_finetune.py)
PORTED = ["continue=1", "keep_snapshots=2", "checkpoint_async=1",
          "checkpoint_fsync=0", "stream_retry=2", "precompile=1",
          "model_dir=memory://m", "sigterm", "task=finetune"]


@pytest.mark.parametrize("what", PORTED)
def test_checkpoint_cli_keys_run(tmp_path, monkeypatch, what):
    """Each key of the checkpoint and CLI slice trains two rounds and
    leaves verified snapshots; a SIGTERM ends the run with the emergency
    snapshot and exit code 75, the process's handler restored."""
    from cxxnet_tpu_torch.main import EXIT_PREEMPTED
    from cxxnet_tpu_torch.nnet.checkpoint import (scan_snapshots,
                                                  verify_snapshot)
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    rng = np.random.RandomState(1)
    _csv(str(tmp_path / "train.csv"), 40, rng)
    _csv(str(tmp_path / "test.csv"), 20, rng)
    with open(str(tmp_path / "c.conf"), "w") as f:
        f.write(CSV_CONF)
    monkeypatch.chdir(tmp_path)
    args = ["c.conf", "dev=cpu", "model_dir=m", "num_round=2"]
    before = signal.getsignal(signal.SIGTERM)
    if what == "sigterm":
        orig = NetTrainer.update

        def update(self, batch):
            orig(self, batch)
            signal.raise_signal(signal.SIGTERM)
        monkeypatch.setattr(NetTrainer, "update", update)
        rc, out = run_cli(LearnTask, args + ["dispatch_period=1"])
        assert rc == EXIT_PREEMPTED
        assert "preempted by signal" in out
        assert signal.getsignal(signal.SIGTERM) is before
        assert [c for c, _ in scan_snapshots("m")] == [0]
        return
    if what == "task=finetune":
        assert run_cli(LearnTask, args)[0] == 0
        args += ["model_in=m/0002.model.npz", "model_dir=ft"]
    if what == "model_dir=memory://m":
        pytest.importorskip("fsspec")
    rc, out = run_cli(LearnTask, args + [what])
    assert rc == 0, out
    mdir = what.split("=", 1)[1] if what.startswith("model_dir") \
        else ("ft" if what == "task=finetune" else "m")
    found = scan_snapshots(mdir)
    assert [c for c, _ in found] == [2, 1]
    for _, name in found:
        assert verify_snapshot("%s/%s" % (mdir, name))["ok"]
    assert signal.getsignal(signal.SIGTERM) is before


IMAGE_NET = """netconfig = start
layer[0->1] = flatten
layer[1->2] = fullc:fc1
  nhidden = 8
layer[2->2] = softmax
netconfig = end
batch_size = 4
input_shape = %s
"""
EXTRA_NET = """extra_data_num = 1
extra_data_shape[0] = 1,1,3
netconfig = start
layer[in,in_1->h] = concat
layer[h->f1] = fullc:fc1
  nhidden = 8
layer[f1->f1] = relu
layer[f1->o] = fullc:fc2
  nhidden = 4
layer[o->o] = softmax
netconfig = end
batch_size = 20
input_shape = 1,1,10
"""


def _image_conf(what, f):
    """The conf of one image-pipeline case: its data block and net."""
    d = f["dir"]
    if what in ("iter=img", "iter=imginst", "iter=imgbin"):
        kind = what[5:]
        src = ("  image_list = %s\n  image_root = %s\n" % (
            os.path.join(d, "img.lst"), os.path.join(d, "imgs"))
            if kind == "img" else
            "  image_list = %s\n  image_bin = %s\n" % (
                os.path.join(d, "part0.lst"), os.path.join(d, "part0.bin")))
        return ("data = train\niter = %s\n%s  rand_crop = 1\n"
                "  rand_mirror = 1\n  mean_value = 123,117,104\n"
                "  silent = 1\niter = threadbuffer\niter = end\n"
                % (kind, src)) + IMAGE_NET % "3,16,16"
    if what == "iter=libsvm":
        return ("data = train\niter = libsvm\n  filename = %s\n"
                "  input_shape = 1,1,12\n  silent = 1\niter = end\n"
                % f["svm"]) + IMAGE_NET % "1,1,12"
    att = "iter = attachtxt\n  filename = %s\n" % f["att"]
    conf = CSV_CONF.replace("  silent = 1\niter = end\neval",
                            "  silent = 1\n%siter = end\neval" % att, 1)
    conf = conf.replace("  silent = 1\niter = end\nnetconfig",
                        "  silent = 1\n%siter = end\nnetconfig" % att, 1)
    if what == "extra_data_num=1":
        conf = conf[:conf.index("netconfig = start")] + EXTRA_NET \
            + conf[conf.index("netconfig = end") + len("netconfig = end"):]
    return conf


@pytest.mark.parametrize("what", ["iter=img", "iter=imginst",
                                  "iter=imgbin", "iter=libsvm",
                                  "iter=attachtxt", "extra_data_num=1"])
def test_image_pipeline_cli_matches_reference(tmp_path, monkeypatch,
                                              what):
    """Each iterator type and key of the image data pipeline runs through
    the port's CLI: ``task = pred`` from one reference snapshot writes
    the reference's file (the pred block of the CSV conf, else the train
    block's deterministic fallback). The reference draws its initial
    weights from numpy here (``test_torch_port_image_io.numpy_init``)."""
    import test_torch_port_image_io as tio
    from cxxnet_tpu.layers.base import LayerParam
    from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
    from cxxnet_tpu.utils.config import parse_config_file
    monkeypatch.setattr(LayerParam, "rand_init_weight", tio.numpy_init)
    rng = np.random.RandomState(1)
    _csv(str(tmp_path / "train.csv"), 40, rng)
    _csv(str(tmp_path / "test.csv"), 20, rng)
    f = tio.make_image_files(tmp_path, shards=1) \
        if what in ("iter=imginst", "iter=imgbin") else \
        {"dir": str(tmp_path), "rows": tio.write_jpegs(str(tmp_path))}
    tio.write_list(str(tmp_path / "img.lst"), f["rows"], 1)
    f["svm"] = tio.write_libsvm(str(tmp_path / "rows.svm"))
    f["att"] = tio.write_attach(str(tmp_path / "extra.txt"), range(0, 40, 3))
    with open(str(tmp_path / "c.conf"), "w") as fh:
        fh.write(_image_conf(what, f))
    monkeypatch.chdir(tmp_path)
    t = RefTrainer(parse_config_file("c.conf"))
    t.init_model()
    t.save_model("s0.model.npz")
    out = {}
    for pkg, cls in (("ref", RefTask), ("port", LearnTask)):
        rc, text = run_cli(cls, ["c.conf", "dev=cpu", "task=pred",
                                 "model_in=s0.model.npz",
                                 "pred=%s.txt" % pkg])
        assert rc == 0, text
        with open("%s.txt" % pkg) as fh:
            out[pkg] = fh.read()
    assert out["port"] == out["ref"]
    assert len(out["ref"].splitlines()) == {
        "iter=img": tio.N_IMG, "iter=imginst": tio.N_IMG,
        "iter=imgbin": tio.N_IMG, "iter=libsvm": 23}.get(what, 20)


def test_no_gpu_without_dev_cpu_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract is moot")
    _csv(str(tmp_path / "train.csv"), 40, np.random.RandomState(2))
    shutil.copy(str(tmp_path / "train.csv"), str(tmp_path / "test.csv"))
    with open(str(tmp_path / "c.conf"), "w") as f:
        f.write(CSV_CONF)
    monkeypatch.chdir(tmp_path)
    for dev in ([], ["dev=gpu"], ["dev=tpu"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_cli(LearnTask, ["c.conf"] + dev)
    assert not os.path.exists(str(tmp_path / "models"))


# ---------------------------------------------------------------- the slice

def _inception_conf(d):
    """Inception-BN.conf's data blocks and precision (imgrec with
    rand_crop, rand_mirror and mean_value behind a threadbuffer; an eval
    block; dtype = bfloat16) around Inception-BN-tiny at 16 px, the
    pixels scaled by 1/128 so that the running BN statistics of a few
    steps give an eval forward that does not saturate the softmax."""
    from cxxnet_tpu_torch.io import recordio
    from cxxnet_tpu_torch.models import inception_bn_tiny
    rng = np.random.RandomState(7)
    for name, n in (("train.rec", 10), ("val.rec", 6)):
        w = recordio.RecordIOWriter(str(d / name))
        for i in range(n):
            w.write_record(recordio.pack_raw_tensor_record(
                i, float(rng.randint(8)),
                rng.randint(0, 256, (20, 20, 3)).astype(np.uint8)))
        w.close()
    blocks = """data = train
iter = imgrec
  path_imgrec = train.rec
  input_shape = 3,16,16
  rand_crop = 1
  rand_mirror = 1
  mean_value = 123,117,104
  scale = 0.0078125
  silent = 1
iter = threadbuffer
iter = end
eval = val
iter = imgrec
  path_imgrec = val.rec
  input_shape = 3,16,16
  mean_value = 123,117,104
  scale = 0.0078125
  silent = 1
iter = end
"""
    conf = str(d / "inception.conf")
    with open(conf, "w") as f:
        f.write(blocks + inception_bn_tiny(nclass=8, batch_size=4,
                                           image_size=16)
                + "dtype = bfloat16\nbn_pallas = 1\nbn_fuse_relu = 1\n")
    return conf


def test_inception_slice_trains_and_predicts(tmp_path, monkeypatch):
    """Inception-BN-tiny through the port's CLI under Inception-BN.conf's
    data blocks and ``dtype = bfloat16`` (without grad_dtype or
    momentum_dtype), ``bn_pallas = bn_fuse_relu = 1``: one round of
    training (10 records at batch 4: two full batches and a tail that
    round_batch wraps, through the threadbuffer), then ``pred`` and
    ``extract`` of the pooled features against the reference's CLI on that
    snapshot (no pred block: both fall back to the train block, crop and
    mirror off).

    The eval forward runs in bf16 in both; the reference's compiled
    program keeps float32 inside its fusions (XLA's excess precision),
    so the pooled features (``flat``, before fc1 and the in-place
    softmax) agree within 2e-2 of their largest magnitude, and the
    predicted class wherever the top two fc1 logits computed from the
    reference's features differ by more than twice that share of the
    largest logit."""
    conf = _inception_conf(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc, out = run_cli(LearnTask, [conf, "dev=cpu", "num_round=1",
                                  "model_dir=port", "eta=0.01"])
    assert rc == 0, out
    m = re.search(r"^\[1\]\ttrain-error:(\S+)\tval-error:(\S+)$", out,
                  re.M)
    assert m and all(0 <= float(v) <= 1 for v in m.groups()), out
    snap = str(tmp_path / "port" / "0001.model.npz")
    arrays, meta = read_snapshot(snap)
    assert meta["update_counter"] == 3          # 10 rows, batch 4
    assert all(np.all(np.isfinite(v)) for k, v in arrays.items()
               if not k.startswith("__"))
    env = {"dir": tmp_path, "conf": conf, "model": snap}
    both(env, "task=extract", "extract_node_name=flat",
         "model_in=" + snap, "pred={pkg}.flat.txt")
    both(env, "task=pred", "model_in=" + snap, "pred={pkg}.pred.txt")
    ref = np.loadtxt(path(env, "ref.flat.txt"), ndmin=2)
    port = np.loadtxt(path(env, "port.flat.txt"), ndmin=2)
    assert ref.shape == port.shape == (10, 72)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())
    # fc1's logits from the reference's features decide where the class
    # is clear of the tolerance
    logits = ref @ arrays["param/fc1/wmat"] + arrays["param/fc1/bias"]
    tol = 2e-2 * np.abs(logits).max()
    ref_cls = np.loadtxt(path(env, "ref.pred.txt"))
    port_cls = np.loadtxt(path(env, "port.pred.txt"))
    top2 = np.sort(logits, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.sum() >= 5
    np.testing.assert_array_equal(ref_cls[clear], logits.argmax(1)[clear])
    np.testing.assert_array_equal(port_cls[clear], ref_cls[clear])


def test_round_counters_match_reference(tmp_path):
    """start_round / end_round / counters_snapshot: an update_many
    window counts as one dispatch, padded rows count as no examples."""
    from cxxnet_tpu.io.data import DataBatch as RefBatch
    from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config
    cfg = parse_config(CSV_CONF)
    snap = str(tmp_path / "0000.model.npz")
    init = RefTrainer(cfg)
    init.init_model()
    init.save_model(snap)
    rng = np.random.RandomState(3)
    x = rng.rand(20, 10).astype(np.float32)
    y = rng.randint(0, 4, (20, 1)).astype(np.float32)
    got = []
    for trainer, batch in ((RefTrainer(cfg), RefBatch),
                           (NetTrainer(cfg, device="cpu"), DataBatch)):
        trainer.load_model(snap)
        trainer.start_round(0)
        trainer.update(batch(data=x, label=y))
        trainer.update_many([batch(data=x, label=y),
                             batch(data=x, label=y, num_batch_padd=5)])
        trainer.end_round()
        trainer.end_round()                  # idempotent
        snap_c = trainer.counters_snapshot()
        got.append((snap_c["steps"], snap_c["examples"], trainer.round,
                    trainer.last_round_examples,
                    trainer.last_round_wall_s > 0,
                    snap_c["last_round_examples_per_sec"] > 0))
    assert got[1] == got[0] == (2, 55, 0, 55, True, True)
