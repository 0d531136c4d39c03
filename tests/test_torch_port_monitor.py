"""The port's telemetry module (``cxxnet_tpu_torch/monitor``) against the
reference's (``cxxnet_tpu/monitor``): the record vocabulary and the
config digest are the reference's exactly; the sinks, ``create_monitor``,
``warn_once`` and the trace window keep the cases of
``tests/test_monitor.py``. The trace window runs ``torch.profiler`` on
the CPU here."""

import json
import os

import numpy as np
import pytest
import torch

from cxxnet_tpu.monitor import config_hash as ref_config_hash
from cxxnet_tpu.monitor import schema as ref_schema
from cxxnet_tpu_torch import monitor
from cxxnet_tpu_torch.monitor import (JsonlSink, LatencyHistogram,
                                      MemorySink, Monitor, NullSink,
                                      StdoutSink, config_hash,
                                      create_monitor,
                                      device_memory_snapshot,
                                      run_metadata, set_global, warn_once)
from cxxnet_tpu_torch.monitor import schema
from cxxnet_tpu_torch.monitor.schema import (read_jsonl, validate_record,
                                             validate_records)


@pytest.mark.parametrize("name", ["REQUIRED", "_TIMING_KEYS",
                                  "_RATIO_KEYS"])
def test_vocabulary_is_the_reference_s(name):
    assert getattr(schema, name) == getattr(ref_schema, name)


def test_config_hash_is_the_reference_s():
    """One config stream, one digest in both packages (the run_start
    record's ``config_hash`` ties a port stream to its config as the
    reference's does); order-sensitive."""
    cfg = [("netconfig", "start"), ("layer[0->1]", "fullc:fc1"),
           ("nhidden", "16"), ("netconfig", "end"), ("batch_size", "20"),
           ("eta", "0.3"), ("monitor", "jsonl")]
    assert config_hash(cfg) == ref_config_hash(cfg)
    assert len(config_hash(cfg)) == 12
    assert config_hash(cfg) != config_hash(cfg[::-1])


# -- sinks and the monitor core --------------------------------------------


def test_null_sink_is_disabled():
    mon = Monitor()
    assert not mon.enabled and isinstance(mon.sink, NullSink)
    mon.emit("step", anything="goes")       # a no-op
    mon.close()


def test_memory_sink_records_and_clears():
    sink = MemorySink()
    mon = Monitor(sink)
    assert mon.enabled
    mon.emit("round_start", round=0)
    assert sink.records[0]["event"] == "round_start"
    assert sink.records[0]["round"] == 0 and sink.records[0]["t"] > 0
    sink.clear()
    assert sink.records == []


def test_line_prints_and_records(capsys):
    sink = MemorySink()
    Monitor(sink).line("hello parity")
    assert capsys.readouterr().out == "hello parity\n"
    assert sink.records == [dict(sink.records[0], event="log",
                                 text="hello parity")]
    Monitor().line("still prints")           # null sink: prints only
    assert capsys.readouterr().out == "still prints\n"


def test_stdout_sink_skips_log_records(capsys):
    mon = Monitor(StdoutSink())
    mon.line("text line")
    mon.emit("round_start", round=3)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "text line"
    assert json.loads(out[1])["round"] == 3 and len(out) == 2


def test_jsonl_sink_flush_and_close(tmp_path):
    p = str(tmp_path / "m.jsonl")
    sink = JsonlSink(p, flush_period=3600.0)   # no flush on time
    mon = Monitor(sink)
    mon.emit("round_start", round=1)
    mon.close()                                # close drains
    recs = read_jsonl(p)
    assert len(recs) == 1 and recs[0]["round"] == 1
    # flush_period 0 flushes every record; re-opening truncates
    sink = JsonlSink(p, flush_period=0.0)
    Monitor(sink).emit("round_start", round=2)
    recs = read_jsonl(p)                       # visible before close
    assert len(recs) == 1 and recs[0]["round"] == 2
    sink.close()


def test_jsonl_sink_rotation(tmp_path):
    """``monitor_rotate_mb``: past the bound the live file rotates to
    ``<path>.<n>`` at a record boundary; stale segments of an earlier
    run at the same path go at open; no record is lost or split."""
    p = str(tmp_path / "r.jsonl")
    for n in (1, 2, 3):
        with open("%s.%d" % (p, n), "w") as f:
            f.write('{"event": "stale"}\n')
    sink = JsonlSink(p, flush_period=0.0, rotate_mb=0.0005)  # 500 bytes
    mon = Monitor(sink)
    for i in range(40):
        mon.emit("round_start", round=i, pad="x" * 64)
    mon.close()
    assert sink.rotations >= 2
    segs = ["%s.%d" % (p, n + 1) for n in range(sink.rotations)]
    rounds = []
    for f in segs + [p]:
        recs = read_jsonl(f)
        assert recs or f == p, "empty segment %s" % f
        rounds += [r["round"] for r in recs]
    assert rounds == list(range(40))
    assert not os.path.exists("%s.%d" % (p, sink.rotations + 1))
    for f in segs:
        assert os.path.getsize(f) <= 500 + 200, f


def test_jsonl_sink_rotation_failure_warns_once_and_keeps_writing(
        tmp_path, capsys, monkeypatch):
    p = str(tmp_path / "f.jsonl")
    sink = JsonlSink(p, flush_period=0.0, rotate_mb=0.0001)

    def boom(src, dst):
        raise OSError("no rotation today")

    monkeypatch.setattr(os, "replace", boom)
    mon = Monitor(sink)
    for i in range(30):
        mon.emit("round_start", round=i)
    mon.close()
    assert capsys.readouterr().err.count("monitor_rotate_failed") == 1
    assert sink.rotations == 0
    assert [r["round"] for r in read_jsonl(p)] == list(range(30))


def test_create_monitor_modes(tmp_path):
    assert not create_monitor([]).enabled
    assert isinstance(create_monitor([("monitor", "none")]).sink, NullSink)
    assert isinstance(create_monitor([("monitor", "stdout")]).sink,
                      StdoutSink)
    m = create_monitor([("monitor", "jsonl"),
                        ("monitor_path", str(tmp_path / "x.jsonl")),
                        ("monitor_flush_period", "0"),
                        ("monitor_rotate_mb", "2.5")])
    assert m.enabled and isinstance(m.sink, JsonlSink)
    assert m.sink.flush_period == 0.0
    assert m.sink.rotate_bytes == int(2.5e6)
    m.close()
    t = create_monitor([("monitor_trace_dir", "tr"),
                        ("monitor_trace_begin", "2"),
                        ("monitor_trace_end", "3")])
    assert (t.trace_dir, t.trace_begin, t.trace_end) == ("tr", 2, 3)
    assert create_monitor([("monitor_trace_dir", "tr")]).trace_end == 1
    with pytest.raises(ValueError):
        create_monitor([("monitor", "bogus")])
    # a non-root process gets a null sink and no trace
    off = create_monitor([("monitor", "jsonl"), ("monitor_trace_dir", "x")],
                         root=False)
    assert not off.enabled and off.trace_dir == ""


def test_warn_once_is_once(capsys):
    sink = MemorySink()
    mon = Monitor(sink)
    mon.warn_once("code_a", "first")
    mon.warn_once("code_a", "second")
    mon.warn_once("code_b", "other")
    assert [r["code"] for r in sink.records
            if r["event"] == "warning"] == ["code_a", "code_b"]
    err = capsys.readouterr().err
    assert err.count("code_a") == 1 and err.count("code_b") == 1
    assert "[cxxnet_tpu_torch] warning code_a: first" in err


def test_module_warn_once_routes_to_global_monitor(capsys):
    """With a monitor installed, ``warn_once`` goes to its stream (once
    per run); without one, to stderr once until ``reset_warnings``."""
    sink = MemorySink()
    set_global(Monitor(sink))
    try:
        warn_once("glob_code", "via global")
        warn_once("glob_code", "again")
    finally:
        set_global(None)
    assert [r["code"] for r in sink.records] == ["glob_code"]
    monitor.reset_warnings()
    warn_once("glob_code", "no monitor")
    warn_once("glob_code", "no monitor")
    assert capsys.readouterr().err.count("no monitor") == 1
    monitor.reset_warnings()
    warn_once("glob_code", "a new run")
    assert "a new run" in capsys.readouterr().err


def test_warn_once_survives_a_dead_sink(capsys):
    class Dead(MemorySink):
        def write(self, record):
            raise OSError("disk gone")
    Monitor(Dead()).warn_once("x", "still warns")
    assert "still warns" in capsys.readouterr().err


def test_latency_histogram_snapshot():
    h = LatencyHistogram()
    for s in (0.0001, 0.0006, 0.010, 0.010, 5.0):
        h.observe(s)
    snap = h.snapshot()
    assert snap["count"] == 5
    assert snap["max_ms"] == pytest.approx(5000.0)
    assert snap["buckets"] == {"<=0.25ms": 1, "<=1ms": 1, "<=16ms": 2,
                               ">1024ms": 1}
    assert validate_record(dict(snap, event="io_wait", t=1.0,
                                round=0)) == []
    h.reset()
    assert h.snapshot()["count"] == 0


def test_validate_records_is_the_reference_s():
    def step(i, rnd=0):
        return {"event": "step", "t": 1.0, "step": i, "round": rnd,
                "dispatch": "update", "n_batches": 1, "examples": 8,
                "wall_ms": 1.0, "data_wait_ms": 0.0,
                "examples_per_sec": 8.0, "update_counter": i,
                "lr": 0.1, "compile": False}
    good = [step(1), step(2), step(3)]
    assert validate_records(good) == ref_schema.validate_records(good) == []
    for bad, msg in (([step(2), step(2)], "not monotonic"),
                     ([step(1, rnd=1), step(2, rnd=0)], "backwards")):
        with pytest.raises(ValueError, match=msg):
            validate_records(bad)
        assert validate_records(bad, strict=False) \
            == ref_schema.validate_records(bad, strict=False)
    assert validate_record({"event": "compile", "t": 1.0, "kind": "first",
                            "signature": "s", "wall_ms": -3.0}) != []


def test_run_metadata_and_memory_on_the_cpu():
    """On the CPU: ``platform`` cpu, ``jax_version`` present and None
    (the port runs no JAX), torch's version; memory not available, as
    the reference reports a CPU backend. Both pass the schema."""
    cfg = [("a", "1")]
    meta = run_metadata("train", cfg, torch.device("cpu"))
    assert meta["platform"] == "cpu" and meta["device_kind"] == "cpu"
    assert "jax_version" in meta and meta["jax_version"] is None
    assert meta["torch_version"] == torch.__version__
    assert meta["config_hash"] == config_hash(cfg)
    assert (meta["process_count"], meta["device_count"], meta["mesh"]) \
        == (1, 1, None)
    assert validate_record(dict(meta, event="run_start", t=1.0)) == []
    mem = device_memory_snapshot(torch.device("cpu"))
    assert mem["available"] is False
    assert validate_record(dict(mem, event="memory", t=1.0, round=0)) == []


# -- the trace window ------------------------------------------------------


def test_trace_window_writes_a_chrome_trace(tmp_path):
    """``torch.profiler`` over rounds [1, 2]: started at the first round
    inside the window, stopped after its last, one Chrome trace that
    names the ops run inside it."""
    sink = MemorySink()
    d = str(tmp_path / "trace")
    mon = Monitor(sink, trace_dir=d, trace_begin=1, trace_end=2)
    x = torch.from_numpy(np.ones((8, 8), np.float32))
    for r in range(4):
        mon.maybe_start_trace(r)
        assert mon._tracing == (r in (1, 2))
        torch.mm(x, x)
        mon.maybe_stop_trace(r)
    mon.close()
    ev = [(r["event"], r.get("round")) for r in sink.records]
    assert ev == [("trace_start", 1), ("trace_stop", 2)]
    path = sink.records[1]["path"]
    assert os.path.basename(path) == "trace_r1-2.json"
    assert os.path.getsize(path) == sink.records[1]["bytes"]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert validate_records(sink.records) == []


def test_trace_stops_at_close_and_late_start(tmp_path):
    """A run that begins past trace_begin (a resume) still traces; a run
    that ends inside the window stops at close, at its last round."""
    sink = MemorySink()
    mon = Monitor(sink, trace_dir=str(tmp_path), trace_begin=1,
                  trace_end=9)
    mon.maybe_start_trace(3)
    mon.maybe_stop_trace(3)
    mon.maybe_stop_trace(4)
    mon.close()
    assert [(r["event"], r["round"]) for r in sink.records] == [
        ("trace_start", 3), ("trace_stop", 4)]


def test_trace_never_started_warns(tmp_path, capsys):
    sink = MemorySink()
    mon = Monitor(sink, trace_dir=str(tmp_path), trace_begin=5)
    mon.maybe_start_trace(0)
    mon.close()
    assert [r["code"] for r in sink.records] == ["trace_never_started"]
    assert "trace_never_started" in capsys.readouterr().err


def test_trace_under_a_running_profiler_warns(tmp_path, capsys):
    """A profiler already running (a caller profiling the run) is left
    alone: ``trace_start_failed``, no trace, and the caller's profile
    still holds the run's ops."""
    from torch.profiler import ProfilerActivity, profile
    sink = MemorySink()
    mon = Monitor(sink, trace_dir=str(tmp_path / "t"), trace_begin=0,
                  trace_end=0)
    x = torch.ones((4, 4))
    with profile(activities=[ProfilerActivity.CPU]) as outer:
        mon.maybe_start_trace(0)
        torch.mm(x, x)
        mon.maybe_stop_trace(0)
    mon.close()
    assert [r.get("code") for r in sink.records] == ["trace_start_failed",
                                                     "trace_never_started"]
    assert not os.path.exists(str(tmp_path / "t"))
    assert any(e.key == "aten::mm" for e in outer.key_averages())
    assert "trace_start_failed" in capsys.readouterr().err


def test_trace_stop_failure_claims_no_trace(tmp_path, monkeypatch):
    sink = MemorySink()
    mon = Monitor(sink, trace_dir=str(tmp_path), trace_begin=0,
                  trace_end=0)
    mon.maybe_start_trace(0)
    prof = mon._profiler

    def boom(path):
        raise OSError("read-only")
    monkeypatch.setattr(prof, "export_chrome_trace", boom)
    mon.maybe_stop_trace(0)
    mon.close()
    assert [(r["event"], r.get("code")) for r in sink.records] == [
        ("trace_start", None), ("warning", "trace_stop_failed")]
