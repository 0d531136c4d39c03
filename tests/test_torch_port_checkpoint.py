"""The port's checkpoint layer (``cxxnet_tpu_torch/nnet/checkpoint.py``,
``utils/stream.py``, ``utils/faultfs.py``, the CLI's ``continue``,
``keep_snapshots``, ``checkpoint_async`` and SIGTERM paths) held to the
reference's fault matrix, ``tests/test_checkpoint.py``, case for case,
on its tiny MLP config (``write_conf``: 200 examples, batch 50).

Deferred with the port items they need, every other assertion kept:
the telemetry records (``checkpoint``, ``preempt``, ``stream_retry``
and the schema check) to ROADMAP queue 1 item 5; ``tools/ckpt_verify.py``
to item 13 (its cases here read ``verify_snapshot`` and
``scan_snapshots`` directly); several ranks to item 10 (the port runs
one process, which is always the root that writes).

Across packages: a reference model_dir with a truncated newest snapshot
resumes under the port's ``continue = 1`` with the same quarantine name
and start counter as under the reference's, and its first update lies
within ``CROSS_RTOL`` / ``CROSS_ATOL`` of the reference's own resumed
first update (the reference's step compiled for one device; XLA:CPU and
PyTorch's CPU products sum in different orders, so not the same bits);
and a port emergency snapshot resumes under the reference.
"""

import io
import json
import os
import shutil
import signal
import threading

import numpy as np
import pytest
import torch

from cxxnet_tpu import parallel as ref_parallel
from cxxnet_tpu.main import main as ref_main
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu_torch import monitor
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.main import EXIT_PREEMPTED, main
from cxxnet_tpu_torch.nnet.checkpoint import (CheckpointManager,
                                              SnapshotFormatError,
                                              SnapshotIntegrityError,
                                              compute_digest,
                                              find_latest_valid,
                                              read_snapshot,
                                              retention_sweep,
                                              scan_snapshots,
                                              verify_snapshot)
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config
from cxxnet_tpu_torch.utils.faultfs import FaultFS
from cxxnet_tpu_torch.utils.stream import (open_stream, register_scheme,
                                           set_stream_retry,
                                           stream_retry_count)
from tests.test_trainer import MLP_CONF, synth_idx

CROSS_RTOL, CROSS_ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def faultfs():
    fs = FaultFS("fault").install()
    try:
        yield fs
    finally:
        fs.uninstall()


@pytest.fixture(autouse=True)
def _reset_retry():
    yield
    set_stream_retry(0)


def make_trainer(extra=()):
    t = NetTrainer(parse_config(MLP_CONF) + list(extra), device="cpu")
    t.init_model()
    return t


def trained_trainer(tmp_path):
    pimg, plab = synth_idx(str(tmp_path), n=600, name="tr")
    it = create_iterator([("iter", "mnist"), ("path_img", pimg),
                          ("path_label", plab), ("shuffle", "1"),
                          ("silent", "1")], [("batch_size", "50")])
    it.init()
    t = make_trainer()
    for batch in it:
        t.update(batch)
    it.close()
    return t


def write_conf(tmp_path, model_dir=None, extra=""):
    pimg, plab = synth_idx(str(tmp_path), n=200, name="tr")
    conf = """
data = train
iter = mnist
  path_img = "%s"
  path_label = "%s"
  silent = 1
iter = end
%s
input_shape = 1,1,256
batch_size = 50
eta = 0.1
metric[label] = error
num_round = 2
save_model = 1
model_dir = "%s"
print_step = 0
eval_train = 0
dev = cpu
%s
""" % (pimg, plab, MLP_CONF.split("input_shape")[0],
       model_dir or str(tmp_path / "models"), extra)
    p = str(tmp_path / "ckpt_run.conf")
    with open(p, "w") as f:
        f.write(conf)
    return p


def _params(path):
    blob, _ = read_snapshot(path)
    return {k: v for k, v in blob.items() if k.startswith("param/")}


# -- atomic local commit --------------------------------------------------


def test_save_is_atomic_and_digested(tmp_path):
    t = trained_trainer(tmp_path)
    path = str(tmp_path / "m" / "0001.model.npz")
    t.save_model(path)
    assert os.path.exists(path)
    assert not os.path.exists(path + ".tmp")
    blob = dict(np.load(path, allow_pickle=False))
    meta = json.loads(bytes(blob["__meta__"]).decode())
    assert meta["format_version"] == 2
    assert meta["content_digest"] == compute_digest(blob)
    t2 = NetTrainer(parse_config(MLP_CONF), device="cpu")
    t2.load_model(path)
    assert t2.update_counter == t.update_counter


def test_kill_between_tmp_write_and_rename_is_invisible(tmp_path):
    t = trained_trainer(tmp_path)
    mdir = str(tmp_path / "m")
    t.save_model(os.path.join(mdir, "0001.model.npz"))
    tmp = os.path.join(mdir, "0002.model.npz.tmp")
    with open(os.path.join(mdir, "0001.model.npz"), "rb") as f:
        partial = f.read()[:1000]
    with open(tmp, "wb") as f:
        f.write(partial)
    rep = find_latest_valid(mdir)
    assert rep.counter == 1
    assert rep.quarantined == []
    assert not os.path.exists(tmp)       # stale tmp swept


def test_continue_skips_zero_byte_and_truncated_newest(tmp_path, capsys):
    conf = write_conf(tmp_path)
    assert main([conf]) == 0
    mdir = tmp_path / "models"
    assert sorted(os.listdir(mdir)) == ["0001.model.npz", "0002.model.npz"]
    (mdir / "0003.model.npz").write_bytes(b"")
    (mdir / "0004.model.npz").write_bytes(
        (mdir / "0002.model.npz").read_bytes()[:512])
    assert main([conf, "continue=1", "num_round=4"]) == 0
    names = sorted(os.listdir(mdir))
    assert "0003.model.npz.quarantined" in names
    assert "0004.model.npz.quarantined" in names
    for n in ("0003.model.npz", "0004.model.npz"):
        assert verify_snapshot(str(mdir / n))["ok"]
    assert "quarantined" in capsys.readouterr().err


def test_continue_all_corrupt_starts_fresh_with_warning(tmp_path, capsys):
    conf = write_conf(tmp_path)
    mdir = tmp_path / "models"
    mdir.mkdir()
    (mdir / "0005.model.npz").write_bytes(b"not an npz")
    assert main([conf, "continue=1"]) == 0
    assert "0001.model.npz" in os.listdir(mdir)
    assert "resume_no_valid_snapshot" in capsys.readouterr().err


# -- format versioning ----------------------------------------------------


def _rewrite_meta(path, mutate):
    blob = dict(np.load(path, allow_pickle=False))
    meta = json.loads(bytes(blob["__meta__"]).decode())
    mutate(meta)
    blob["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **blob)


def test_future_format_version_raises_clearly(tmp_path):
    t = trained_trainer(tmp_path)
    path = str(tmp_path / "0001.model.npz")
    t.save_model(path)
    _rewrite_meta(path, lambda m: m.update(format_version=99))
    t2 = NetTrainer(parse_config(MLP_CONF), device="cpu")
    with pytest.raises(SnapshotFormatError, match="format_version 99"):
        t2.load_model(path)


def test_v1_snapshot_without_digest_still_loads(tmp_path):
    t = trained_trainer(tmp_path)
    path = str(tmp_path / "0001.model.npz")
    t.save_model(path)
    _rewrite_meta(path, lambda m: (m.pop("content_digest"),
                                   m.update(format_version=1)))
    t2 = NetTrainer(parse_config(MLP_CONF), device="cpu")
    t2.load_model(path)
    assert t2.update_counter == t.update_counter
    rep = verify_snapshot(path)
    assert rep["ok"] and rep["digest"] == "missing"


# -- digest corruption ----------------------------------------------------


def _corrupt_array(path):
    blob = dict(np.load(path, allow_pickle=False))
    key = sorted(k for k in blob if k.startswith("param/"))[0]
    arr = np.array(blob[key])
    arr.flat[0] += 1.0
    blob[key] = arr
    with open(path, "wb") as f:
        np.savez(f, **blob)


def test_digest_mismatch_rejected_and_resume_falls_back(tmp_path, capsys):
    t = trained_trainer(tmp_path)
    mdir = str(tmp_path / "m")
    t.save_model(os.path.join(mdir, "0001.model.npz"))
    t.save_model(os.path.join(mdir, "0002.model.npz"))
    _corrupt_array(os.path.join(mdir, "0002.model.npz"))
    with pytest.raises(SnapshotIntegrityError, match="digest"):
        NetTrainer(parse_config(MLP_CONF), device="cpu").load_model(
            os.path.join(mdir, "0002.model.npz"))
    monitor.reset_warnings()
    capsys.readouterr()
    rep = find_latest_valid(mdir)
    assert rep.counter == 1
    assert rep.quarantined == ["0002.model.npz"]
    warned = [ln for ln in capsys.readouterr().err.splitlines()
              if " warning " in ln]
    assert len(warned) == 1
    assert "warning snapshot_quarantined:0002.model.npz:" in warned[0]
    assert os.path.exists(os.path.join(mdir, "0002.model.npz.quarantined"))


# -- fault injection: ENOSPC / torn remote commit -------------------------


def test_enospc_mid_serialize_direct_api_raises(tmp_path, faultfs):
    t = trained_trainer(tmp_path)
    faultfs.enospc_after = 4096
    with pytest.raises(OSError, match="space"):
        t.save_model("fault://ckpt/0001.model.npz")
    assert faultfs.store == {}


def test_enospc_managed_save_warns_and_training_survives(tmp_path,
                                                         faultfs, capsys):
    conf = write_conf(tmp_path, model_dir="fault://ckpt")
    faultfs.enospc_after = 4096
    assert main([conf]) == 0
    assert not scan_snapshots("fault://ckpt")
    assert "checkpoint_write_failed" in capsys.readouterr().err
    assert faultfs.counters["enospc"] == 2      # both rounds' commits


def test_remote_payload_without_manifest_is_uncommitted(tmp_path,
                                                        faultfs):
    t = trained_trainer(tmp_path)
    t.save_model("fault://ckpt/0001.model.npz")
    assert scan_snapshots("fault://ckpt") == [(1, "0001.model.npz")]
    faultfs.fail_write_substr = ".ok"
    with pytest.raises(IOError, match="injected write failure"):
        t.save_model("fault://ckpt/0002.model.npz")
    faultfs.clear_faults()
    assert "fault://ckpt/0002.model.npz" in faultfs.store
    rep = find_latest_valid("fault://ckpt")
    assert rep.counter == 1


def test_remote_rewrite_drops_manifest_before_payload(tmp_path, faultfs):
    t = trained_trainer(tmp_path)
    t.save_model("fault://rw/0001.model.npz")
    faultfs.fail_write_substr = "0001.model.npz"
    with pytest.raises(IOError, match="injected write failure"):
        t.save_model("fault://rw/0001.model.npz")
    faultfs.clear_faults()
    assert "fault://rw/0001.model.npz" in faultfs.store
    assert "fault://rw/0001.model.npz.ok" not in faultfs.store
    assert scan_snapshots("fault://rw") == []


def test_scan_snapshots_is_read_only_for_inflight_tmp(tmp_path):
    t = trained_trainer(tmp_path)
    mdir = str(tmp_path / "m")
    t.save_model(os.path.join(mdir, "0001.model.npz"))
    tmp = os.path.join(mdir, "0002.model.npz.tmp")
    with open(tmp, "wb") as f:
        f.write(b"in-flight")
    assert scan_snapshots(mdir) == [(1, "0001.model.npz")]
    assert os.path.exists(tmp)
    assert all(verify_snapshot(os.path.join(mdir, n))["ok"]
               for _, n in scan_snapshots(mdir))
    assert os.path.exists(tmp)
    rep = find_latest_valid(mdir)
    assert rep.counter == 1
    assert not os.path.exists(tmp)


def test_remote_torn_payload_detected_by_manifest(tmp_path, faultfs):
    t = trained_trainer(tmp_path)
    t.save_model("fault://ckpt/0001.model.npz")
    t.save_model("fault://ckpt/0002.model.npz")
    uri = "fault://ckpt/0002.model.npz"
    faultfs.store[uri] = faultfs.store[uri][:-2048]
    rep2 = verify_snapshot(uri)
    assert not rep2["ok"] and "size mismatch" in rep2["error"]
    rep = find_latest_valid("fault://ckpt")
    assert rep.counter == 1
    assert rep.quarantined == ["0002.model.npz"]
    assert "fault://ckpt/0002.model.npz.quarantined" in faultfs.store
    assert scan_snapshots("fault://ckpt") == [(1, "0001.model.npz")]


def test_continue_resumes_from_fake_remote_model_dir(tmp_path, faultfs):
    conf = write_conf(tmp_path, model_dir="fault://run")
    assert main([conf]) == 0
    assert [c for c, _ in scan_snapshots("fault://run")] == [2, 1]
    uri = "fault://run/0002.model.npz"
    data = bytearray(faultfs.store[uri])
    data[len(data) // 2] ^= 0xFF
    faultfs.store[uri] = bytes(data)
    assert main([conf, "continue=1", "num_round=3"]) == 0
    assert [c for c, _ in scan_snapshots("fault://run")] == [3, 2, 1]
    assert verify_snapshot("fault://run/0002.model.npz")["ok"]


# -- async writer ---------------------------------------------------------


def test_async_save_returns_before_commit(tmp_path):
    """The training thread pays only the gather: save() returns while
    the commit is still gated; close() drains it."""
    store = {}
    gate = threading.Event()

    class _GatedFile(io.BytesIO):
        def __init__(self, uri):
            super().__init__()
            self._uri = uri

        def close(self):
            gate.wait(timeout=30)
            store[self._uri] = self.getvalue()
            super().close()

    def _gated_open(uri, mode):
        f = _GatedFile(uri)
        return f if "b" in mode else io.TextIOWrapper(f)

    register_scheme("gated", _gated_open)
    try:
        t = trained_trainer(tmp_path)
        ckpt = CheckpointManager(
            t, lambda c: "gated://m/%04d.model.npz" % c,
            model_dir="gated://m", async_=True)
        ckpt.save(1)
        assert store == {}
        gate.set()
        ckpt.close()
        assert "gated://m/0001.model.npz" in store
        assert ckpt.commits == 1 and ckpt.failures == 0
        c = ckpt.last_commit
        assert c["status"] == "ok" and c["serialize_ms"] >= 0
        assert ckpt.last_save["gather_ms"] >= 0
    finally:
        register_scheme("gated", None)


def test_gathered_arrays_survive_later_updates(tmp_path):
    """The async writer digests host copies: an in-place write to a
    live weight after the gather does not reach the snapshot."""
    t = trained_trainer(tmp_path)
    arrays, _ = t.gather_snapshot()
    before = {k: v.copy() for k, v in arrays.items()}
    with torch.no_grad():
        for sub in t.params.values():
            for v in sub.values():
                v.add_(1.0)
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, before[k])


def test_single_process_save_writes_as_root(tmp_path):
    """The port runs one process, which always writes (the reference's
    several-rank case waits for the multi-GPU item)."""
    t = trained_trainer(tmp_path)
    path = str(tmp_path / "rank0" / "0001.model.npz")
    ckpt = CheckpointManager(t, lambda c: path)
    ckpt.save(1)
    ckpt.close()
    assert verify_snapshot(path)["ok"]


# -- retention ------------------------------------------------------------


def test_keep_snapshots_gc(tmp_path):
    conf = write_conf(tmp_path, extra="keep_snapshots = 2\n")
    assert main([conf, "num_round=5"]) == 0
    mdir = tmp_path / "models"
    assert sorted(os.listdir(mdir)) == ["0004.model.npz", "0005.model.npz"]


def test_retention_sweep_remote_removes_manifest_first(faultfs, tmp_path):
    t = trained_trainer(tmp_path)
    for c in (1, 2, 3):
        t.save_model("fault://gc/%04d.model.npz" % c)
    removed = retention_sweep("fault://gc", keep=1)
    assert removed == ["0002.model.npz", "0001.model.npz"]
    assert set(faultfs.store) == {"fault://gc/0003.model.npz",
                                  "fault://gc/0003.model.npz.ok"}
    assert retention_sweep("fault://gc", keep=0) == []


# -- preemption -----------------------------------------------------------


def _preempted_run(tmp_path, monkeypatch, conf, at=3):
    """Run the port's CLI with SIGTERM raised after update ``at`` (mid
    round 0: 4 batches a round); returns its rc."""
    calls = {"n": 0}
    orig = NetTrainer.update

    def patched(self, batch):
        out = orig(self, batch)
        calls["n"] += 1
        if calls["n"] == at:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(NetTrainer, "update", patched)
    try:
        return main([conf, "num_round=100000"])
    finally:
        monkeypatch.setattr(NetTrainer, "update", orig)


def test_sigterm_triggers_emergency_snapshot_and_resume(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    conf = write_conf(tmp_path, extra="dispatch_period = 1\n")
    before = signal.getsignal(signal.SIGTERM)
    assert _preempted_run(tmp_path, monkeypatch, conf) == EXIT_PREEMPTED
    mdir = tmp_path / "models"
    assert os.listdir(mdir) == ["0000.model.npz"]
    assert verify_snapshot(str(mdir / "0000.model.npz"))["ok"]
    _, meta = read_snapshot(str(mdir / "0000.model.npz"))
    assert meta["update_counter"] == 3
    assert "preempted by signal %d" % signal.SIGTERM \
        in capsys.readouterr().out
    # the run's handler was restored on exit
    assert signal.getsignal(signal.SIGTERM) is before
    # and the emergency snapshot resumes: round 0 re-runs from its start
    assert main([conf, "continue=1", "num_round=1"]) == 0
    assert "0001.model.npz" in os.listdir(mdir)
    _, meta = read_snapshot(str(mdir / "0001.model.npz"))
    assert meta["update_counter"] == 3 + 4


# -- stream retry ---------------------------------------------------------


def test_stream_retry_recovers_transient_open_failures(faultfs, capsys):
    monitor.reset_warnings()
    faultfs.store["fault://d/x.bin"] = b"payload"
    faultfs.fail_opens = 2
    set_stream_retry(0)
    with pytest.raises(IOError):
        open_stream("fault://d/x.bin", "rb")
    faultfs.fail_opens = 2
    set_stream_retry(3, base_ms=1.0)
    recovered = stream_retry_count()
    with open_stream("fault://d/x.bin", "rb") as f:
        assert f.read() == b"payload"
    assert stream_retry_count() == recovered + 1
    assert "stream_retry" in capsys.readouterr().err
    faultfs.fail_opens = 10
    with pytest.raises(IOError):
        open_stream("fault://d/x.bin", "rb")


def test_stream_retry_covers_snapshot_reads(faultfs, tmp_path):
    t = trained_trainer(tmp_path)
    t.save_model("fault://d/0001.model.npz")
    set_stream_retry(3, base_ms=1.0)
    faultfs.fail_reads = 2
    blob, meta = read_snapshot("fault://d/0001.model.npz")
    assert meta["content_digest"] == compute_digest(blob)


# -- the verifier's cases, through verify_snapshot -------------------------


def test_verify_cases(tmp_path, faultfs):
    t = trained_trainer(tmp_path)
    mdir = str(tmp_path / "m")
    t.save_model(os.path.join(mdir, "0001.model.npz"))
    t.save_model(os.path.join(mdir, "0002.model.npz"))
    reps = [verify_snapshot(os.path.join(mdir, n))
            for _, n in scan_snapshots(mdir)]
    assert [r["ok"] for r in reps] == [True, True]
    assert all(r["digest"] == "match" for r in reps)
    _corrupt_array(os.path.join(mdir, "0002.model.npz"))
    rep = verify_snapshot(os.path.join(mdir, "0002.model.npz"))
    assert not rep["ok"] and "digest mismatch" in rep["error"]
    # remote: a manifest-less payload is uncommitted, not corrupt
    t.save_model("fault://v/0001.model.npz")
    del faultfs.store["fault://v/0001.model.npz.ok"]
    t.save_model("fault://v/0002.model.npz")
    assert scan_snapshots("fault://v") == [(2, "0002.model.npz")]
    faultfs.truncate_tail = 512
    t.save_model("fault://v/0003.model.npz")
    faultfs.clear_faults()
    assert not verify_snapshot("fault://v/0003.model.npz")["ok"]
    rep = verify_snapshot("fault://v/0099.model.npz")
    assert not rep["ok"] and "unreadable" in rep["error"]


# -- precompile and stream_retry leave results alone ----------------------


@pytest.mark.parametrize("key", ["precompile=1", "stream_retry=2"])
def test_key_gives_identical_snapshots(tmp_path, key):
    conf = write_conf(tmp_path)
    assert main([conf, "model_dir=" + str(tmp_path / "a")]) == 0
    assert main([conf, key, "model_dir=" + str(tmp_path / "b")]) == 0
    for n in ("0001.model.npz", "0002.model.npz"):
        a, b = (_params(str(tmp_path / d / n)) for d in "ab")
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_precompile_leaves_the_trainer_as_it_was(tmp_path):
    t = trained_trainer(tmp_path)
    t.save_optimizer = 1                 # the momentum is held too
    before, _ = t.gather_snapshot()
    counters = (t.update_counter, t.sample_counter, t._steps_total)
    rng = torch.get_rng_state()
    t.precompile()
    after, _ = t.gather_snapshot()
    assert sorted(before) == sorted(after)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    assert (t.update_counter, t.sample_counter, t._steps_total) == counters
    assert torch.equal(torch.get_rng_state(), rng)


# -- across packages ------------------------------------------------------


def _first_update(monkeypatch, cls, run):
    """Parameters after the first ``update`` of ``cls`` during
    ``run()`` (as numpy, reference layouts), and run's rc."""
    got = {}
    orig = cls.update

    def patched(self, batch):
        out = orig(self, batch)
        if not got:
            got.update({"%s/%s" % (lk, tag): np.array(v)
                        for lk, sub in self.params.items()
                        for tag, v in sub.items()})
        return out

    monkeypatch.setattr(cls, "update", patched)
    try:
        rc = run()
    finally:
        monkeypatch.setattr(cls, "update", orig)
    return got, rc


def test_reference_model_dir_resumes_in_the_port(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_parallel, "default_data_axis",
                        lambda *a, **k: 1)
    conf = write_conf(tmp_path, extra="dispatch_period = 1\n")
    assert ref_main([conf]) == 0
    src = tmp_path / "models"
    newest = src / "0002.model.npz"
    newest.write_bytes(newest.read_bytes()[:4096])
    dirs = {}
    for pkg in ("ref", "port"):
        dirs[pkg] = tmp_path / pkg
        shutil.copytree(str(src), str(dirs[pkg]))
    ref_up, rc = _first_update(monkeypatch, RefTrainer, lambda: ref_main(
        [conf, "continue=1", "model_dir=" + str(dirs["ref"])]))
    assert rc == 0
    port_up, rc = _first_update(monkeypatch, NetTrainer, lambda: main(
        [conf, "continue=1", "model_dir=" + str(dirs["port"])]))
    assert rc == 0
    names = {pkg: sorted(os.listdir(d)) for pkg, d in dirs.items()}
    assert names["port"] == names["ref"] == [
        "0001.model.npz", "0002.model.npz", "0002.model.npz.quarantined"]
    # both resumed from counter 1: one round of 4 updates on top of it
    for pkg, d in dirs.items():
        _, meta = read_snapshot(str(d / "0002.model.npz"))
        assert meta["update_counter"] == 8, pkg
    assert sorted(port_up) == sorted(ref_up)
    for k in ref_up:
        np.testing.assert_allclose(port_up[k], ref_up[k], rtol=CROSS_RTOL,
                                   atol=CROSS_ATOL, err_msg=k)


def test_port_emergency_snapshot_resumes_in_the_reference(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(ref_parallel, "default_data_axis",
                        lambda *a, **k: 1)
    conf = write_conf(tmp_path, extra="dispatch_period = 1\n")
    assert _preempted_run(tmp_path, monkeypatch, conf) == EXIT_PREEMPTED
    src = tmp_path / "models"
    assert os.listdir(src) == ["0000.model.npz"]
    ref_dir = tmp_path / "ref"
    shutil.copytree(str(src), str(ref_dir))
    assert ref_main([conf, "continue=1", "num_round=1",
                     "model_dir=" + str(ref_dir)]) == 0
    assert main([conf, "continue=1", "num_round=1"]) == 0
    a = _params(str(ref_dir / "0001.model.npz"))
    b = _params(str(src / "0001.model.npz"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=CROSS_RTOL,
                                   atol=CROSS_ATOL, err_msg=k)
