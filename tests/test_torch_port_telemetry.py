"""Telemetry parity: one tiny CSV config through both packages' CLIs
(``cxxnet_tpu.main`` and ``cxxnet_tpu_torch.main``, in process, ``dev =
cpu``) with ``monitor = jsonl``.

The config trains 10 batches of 20 a round through a ``threadbuffer``
chain with ``dispatch_period = 4``, so a round is two ``update_many``
windows and a tail of two per-batch updates, and commits its snapshots
inline (``checkpoint_async = 0``: an async commit's record lands where
the writer thread happens to finish). Each package trains from its own
initialization, so the held values are the structural ones: the record
kinds in order, the step and round counters, ``model_info`` and
``layout`` exactly; every stream passes both packages'
``validate_records``. The checkpoint flows (resume, preemption,
finetune) and the other tasks run from each package's own snapshot.
"""

import contextlib
import io
import json
import os
import re
import signal

import numpy as np
import pytest
import torch

from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.monitor.schema import validate_records as ref_validate
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu_torch.main import EXIT_PREEMPTED, LearnTask
from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
from cxxnet_tpu_torch.nnet.trainer import NetTrainer

CONF = """data = train
iter = csv
  filename = train.csv
  input_shape = 1,1,10
  label_width = 1
  silent = 1
iter = threadbuffer
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
num_round = 2
metric = error
dispatch_period = 4
print_step = 4
checkpoint_async = 0
"""

PACKAGES = {"ref": RefTask, "port": LearnTask}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _csv(path, n, rng):
    x = rng.rand(n, 10).astype(np.float32)
    y = (x @ rng.randn(10, 4)).argmax(1)
    with open(path, "w") as f:
        for i in range(n):
            f.write(",".join([str(y[i])] + ["%.5f" % v for v in x[i]])
                    + "\n")


def cli(pkg, *args):
    """(rc, stdout, records) of one in-process run of ``pkg``'s CLI with
    ``monitor = jsonl`` into ``<pkg>.jsonl``; each package writes its
    model files under its own directory."""
    buf = io.StringIO()
    mpath = "%s.jsonl" % pkg
    argv = ["c.conf", "dev=cpu", "model_dir=" + pkg, "monitor=jsonl",
            "monitor_path=" + mpath]
    argv += [a.replace("{pkg}", pkg) for a in args]
    with contextlib.redirect_stdout(buf):
        rc = PACKAGES[pkg]().run(argv)
    return rc, buf.getvalue(), read_jsonl(mpath)


def kinds(recs):
    return [r["event"] for r in recs]


def valid(recs) -> bool:
    return validate_records(recs) == [] and ref_validate(recs) == []


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    """Both packages' training runs: {pkg: (rc, stdout, records)}; the
    working directory holds their snapshots ``<pkg>/000{1,2}``."""
    d = tmp_path_factory.mktemp("telemetry")
    rng = np.random.RandomState(0)
    _csv(str(d / "train.csv"), 200, rng)
    _csv(str(d / "test.csv"), 60, rng)
    with open(str(d / "c.conf"), "w") as f:
        f.write(CONF)
    old = os.getcwd()
    os.chdir(str(d))
    try:
        yield {pkg: cli(pkg) for pkg in PACKAGES}
    finally:
        os.chdir(old)


def test_train_stream_kinds_match_the_reference(train):
    (rrc, _, ref), (prc, _, port) = train["ref"], train["port"]
    assert rrc == prc == 0
    assert kinds(port) == kinds(ref)
    assert valid(port)
    k = kinds(port)
    assert k[:3] == ["model_info", "layout", "run_start"]
    assert k[-1] == "run_end"
    for ev in ("io_wait", "pipeline", "memory", "round_end", "checkpoint"):
        assert k.count(ev) == 2, ev


def test_model_records_carry_the_reference_values(train):
    for ev in ("model_info", "layout"):
        (r,) = [x for x in train["ref"][2] if x["event"] == ev]
        (p,) = [x for x in train["port"][2] if x["event"] == ev]
        assert {k: v for k, v in p.items() if k != "t"} \
            == {k: v for k, v in r.items() if k != "t"}, ev


def test_step_and_round_counters_match_the_reference(train):
    """Per step: its id, round, dispatch kind, batches, rows, update
    counter, learning rate and compile flag (a first sighting of the
    update_many and the update signature); per round its rows; the
    run's totals."""
    keys = ("step", "round", "dispatch", "n_batches", "examples",
            "update_counter", "lr", "compile")

    def of(recs, ev, ks):
        return [tuple(r[k] for k in ks) for r in recs if r["event"] == ev]
    ref, port = train["ref"][2], train["port"][2]
    assert of(port, "step", keys) == of(ref, "step", keys)
    assert [s[2] for s in of(port, "step", keys)] == \
        ["update_many", "update_many", "update", "update"] * 2
    assert of(port, "compile", ("kind",)) == [("first",), ("recompile",)]
    assert of(port, "round_end", ("round", "examples")) == \
        of(ref, "round_end", ("round", "examples")) == [(0, 200), (1, 200)]
    assert of(port, "run_end", ("steps", "examples")) == [(8, 400)]
    assert of(port, "io_wait", ("round", "count")) == \
        of(ref, "io_wait", ("round", "count")) == [(0, 10), (1, 10)]
    assert of(port, "pipeline", ("batches",)) == \
        of(ref, "pipeline", ("batches",))
    assert of(port, "eval", ("round", "name")) == \
        of(ref, "eval", ("round", "name"))
    assert of(port, "checkpoint", ("counter", "status", "emergency",
                                   "async_write")) == \
        [(1, "ok", False, False), (2, "ok", False, False)]


def test_eval_records_are_the_printed_lines(train):
    """The ``eval`` records' values are the round lines' (``log``
    records hold the lines as printed)."""
    port = train["port"][2]
    lines = [r["text"] for r in port if r["event"] == "log"
             and r["text"].startswith("[")]
    assert len(lines) == 2
    for rnd, line in enumerate(lines):
        for name in ("train", "test"):
            (ev,) = [r for r in port if r["event"] == "eval"
                     and r["round"] == rnd and r["name"] == name]
            m = re.search(r"\t%s-error:(\S+)" % name, line)
            assert float(m.group(1)) == pytest.approx(
                ev["metrics"]["error"], abs=1e-6)


def test_stdout_same_across_monitor_modes(train):
    """``monitor = none`` and ``jsonl`` print the same bytes;
    ``stdout`` adds only JSON record lines, which validate (the
    reference's ``test_stdout_parity_across_monitor_modes``). Elapsed
    seconds are normalized."""
    def run(*args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert LearnTask().run(["c.conf", "dev=cpu", "num_round=1",
                                    "model_dir=modes"] + list(args)) == 0
        return buf.getvalue()

    def norm(out):
        return re.sub(r"\d+ sec", "N sec", out)
    base = run()
    assert "round        0:[       4]" in base
    assert norm(run("monitor=jsonl", "monitor_path=modes.jsonl")) \
        == norm(base)
    sout = run("monitor=stdout")
    text = [ln for ln in sout.splitlines() if not ln.startswith("{")]
    assert norm("\n".join(text) + "\n") == norm(base)
    recs = [json.loads(ln) for ln in sout.splitlines()
            if ln.startswith("{")]
    assert "log" not in kinds(recs) and "step" in kinds(recs)
    assert valid(recs)


@pytest.mark.parametrize("task", ["pred", "extract", "get_weight",
                                  "test_io"])
def test_task_streams_match_the_reference(train, task):
    """``run_start`` ... ``task_end`` (``test_io`` for test_io) in the
    same kinds and order, from each package's snapshot of round 2."""
    args = {"pred": ["task=pred", "pred={pkg}.pred.txt"],
            "extract": ["task=extract", "extract_node_name=top",
                        "pred={pkg}.extract.txt"],
            "get_weight": ["task=get_weight", "weight_layer=fc1",
                           "weight_filename={pkg}.weight.txt"],
            "test_io": ["test_io=1", "num_round=1"]}[task]
    if task != "test_io":
        args.append("model_in={pkg}/0002.model.npz")
    runs = {pkg: cli(pkg, *args) for pkg in PACKAGES}
    (rrc, _, ref), (prc, _, port) = runs["ref"], runs["port"]
    assert rrc == prc == 0
    assert kinds(port) == kinds(ref)
    assert valid(port)
    end = port[-1]
    if task == "test_io":
        assert end["event"] == "test_io" and end["instances"] == 200
    else:
        assert end["event"] == "task_end" and end["task"] == task
        assert end.get("rows") == ref[-1].get("rows")


def test_quantize_stream_matches_the_reference(train):
    runs = {pkg: cli(pkg, "task=quantize",
                     "model_in={pkg}/0002.model.npz",
                     "quantize_out={pkg}.int8.npz")
            for pkg in PACKAGES}
    (rrc, _, ref), (prc, _, port) = runs["ref"], runs["port"]
    assert rrc == prc == 0
    assert kinds(port) == kinds(ref)
    assert valid(port)
    (q,) = [r for r in port if r["event"] == "quantize"]
    (rq,) = [r for r in ref if r["event"] == "quantize"]
    assert (q["dtype"], q["batches"], q["layers"]) == \
        (rq["dtype"], rq["batches"], rq["layers"]) == ("int8", 3, 2)
    assert q["parity_mean_abs"] <= 0.05 and q["out"] == "port.int8.npz"


def test_serve_stream(train):
    """The serve task's stream: the batcher's records, a
    ``serve_summary`` without failures and ``task_end`` last."""
    rc, out, recs = cli("port", "task=serve",
                        "model_in={pkg}/0002.model.npz", "serve_clients=4",
                        "serve_requests=6", "serve_request_rows=3",
                        "serve_buckets=1,4,8", "serve_max_batch=8")
    assert rc == 0, out
    assert valid(recs)
    k = kinds(recs)
    assert k[:4] == ["run_start", "model_info", "layout",
                     "weight_residency"]
    assert k.count("serve_request") == 24 and "serve_batch" in k
    (s,) = [r for r in recs if r["event"] == "serve_summary"]
    assert s["requests"] == 24 and s["rows"] == 72
    assert s["rejected"] == s["timeouts"] == s["errors"] == 0
    assert recs[-1]["event"] == "task_end" and recs[-1]["rows"] == 72


def test_resume_records_match_the_reference(train):
    """``continue = 1`` over each package's model dir: the ``resume``
    record names the newest snapshot, and round 2 trains."""
    for pkg in PACKAGES:
        assert cli(pkg, "model_dir={pkg}_resume")[0] == 0
    runs = {pkg: cli(pkg, "continue=1", "num_round=3",
                     "model_dir={pkg}_resume") for pkg in PACKAGES}
    (rrc, _, ref), (prc, _, port) = runs["ref"], runs["port"]
    assert rrc == prc == 0
    assert kinds(port) == kinds(ref)
    assert valid(port)
    (rs,) = [r for r in port if r["event"] == "resume"]
    assert (rs["counter"], rs["scanned"], rs["quarantined"]) == (2, 1, 0)
    assert rs["source"].endswith("0002.model.npz")
    assert [r["round"] for r in port if r["event"] == "round_start"] == [2]


def test_preempt_records_match_the_reference(train, monkeypatch):
    """SIGTERM after the third update: the stream ends with the
    preemption line, the emergency ``checkpoint`` and ``preempt``."""
    def signalling(cls):
        orig = cls.update

        def update(self, batch):
            orig(self, batch)
            if self.counters_snapshot()["steps"] == 3:
                signal.raise_signal(signal.SIGTERM)
        return update
    monkeypatch.setattr(RefTrainer, "update", signalling(RefTrainer))
    monkeypatch.setattr(NetTrainer, "update", signalling(NetTrainer))
    runs = {pkg: cli(pkg, "dispatch_period=1", "model_dir={pkg}_pre")
            for pkg in PACKAGES}
    (rrc, _, ref), (prc, _, port) = runs["ref"], runs["port"]
    assert rrc == prc == EXIT_PREEMPTED
    assert kinds(port) == kinds(ref)
    assert valid(port)
    assert kinds(port)[-3:] == ["log", "checkpoint", "preempt"]
    ck, pre = port[-2], port[-1]
    assert (ck["counter"], ck["emergency"], ck["status"]) == (0, True, "ok")
    assert (pre["signal"], pre["round"], pre["exit_code"]) == \
        (int(signal.SIGTERM), 0, EXIT_PREEMPTED)


def test_finetune_records_match_the_reference(train):
    runs = {pkg: cli(pkg, "task=finetune", "model_in={pkg}/0002.model.npz",
                     "finetune_remap=fc2", "num_round=1",
                     "model_dir={pkg}_ft") for pkg in PACKAGES}
    (rrc, _, ref), (prc, _, port) = runs["ref"], runs["port"]
    assert rrc == prc == 0
    assert kinds(port) == kinds(ref)
    assert valid(port)
    (ft,) = [r for r in port if r["event"] == "finetune"]
    (rft,) = [r for r in ref if r["event"] == "finetune"]
    keys = ("carried", "remapped", "fresh", "carried_layers",
            "remapped_layers", "frozen_groups")
    assert [ft[k] for k in keys] == [rft[k] for k in keys]
    assert (ft["carried"], ft["remapped_layers"]) == (1, ["fc2"])
