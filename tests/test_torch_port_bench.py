"""The port's bench entry (``python -m cxxnet_tpu_torch.bench``) against
the repo-root ``bench.py``.

The cases of ``tests/test_bench_capture.py`` run as one parametrised
test over both modules: the same inputs give the same outputs and the
same errors. A CPU run of the port's entry prints a record with the
reference record's keys; ``--compare`` exits 2 before the sweep on a
corrupt or cross-dtype record; the multi-GPU flags raise
``NotPortedError``. No test reads a bench record of the repo."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import bench as ref_bench
from cxxnet_tpu_torch import bench as port_bench
from cxxnet_tpu_torch.utils.config import NotPortedError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"bench": ref_bench, "cxxnet_tpu_torch.bench": port_bench}
# how each module runs as a program
COMMANDS = {"bench": ["bench.py"],
            "cxxnet_tpu_torch.bench": ["-m", "cxxnet_tpu_torch.bench"]}


def _fake_windows(dts):
    it = iter(dts)
    return lambda: next(it)


def _stable(mod, tmp_path):
    best, dts, suspect = mod.capture(_fake_windows([1.0, 1.05, 99.0]))
    assert (best, dts, suspect) == (1.0, [1.0, 1.05], False)
    return best, dts, suspect


def _stall_recovered(mod, tmp_path):
    best, dts, suspect = mod.capture(_fake_windows([10.0, 1.0, 1.02]))
    assert (best, len(dts), suspect) == (1.0, 3, False)
    assert mod.agreeing_spread(dts) == 1.02
    return best, dts, suspect, mod.agreeing_spread(dts)


def _run(name, args, tmp_path):
    p = subprocess.run(
        [sys.executable] + COMMANDS[name] + args, capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return p.returncode, p.stderr.strip().splitlines()[-1]


def _corrupt_record(name, tmp_path):
    f = tmp_path / "BENCH_bad.json"
    f.write_text(json.dumps({"rc": 1, "parsed": None}))
    rc, err = _run(name, ["--compare", str(f)], tmp_path)
    assert rc == 2 and "no usable bench record" in err
    return rc, err.split(": error: ")[1]


def _persistent_disagreement(mod, tmp_path):
    best, dts, suspect = mod.capture(_fake_windows([10.0, 1.0, 9.5]))
    assert best == 1.0 and suspect
    return best, dts, suspect


def _sleep_stall(mod, tmp_path):
    calls = {"n": 0}

    def window():
        calls["n"] += 1
        start = time.perf_counter()
        if calls["n"] == 1:
            time.sleep(0.30)           # 10x stall
        time.sleep(0.03)
        return time.perf_counter() - start

    best, dts, suspect = mod.capture(window)
    assert calls["n"] == 3 and best < 0.1 and not suspect
    return calls["n"], suspect


def _beyond_spread(mod, tmp_path):
    old = {"alexnet": {"value": 20000.0, "spread": 1.1},
           "inception_bn": 5280.0,
           "kaiming": 9500.0}
    new = {"alexnet": {"value": 9000.0, "spread": 1.05},
           "inception_bn": {"value": 5100.0, "spread": 1.08},
           "kaiming": {"value": 12000.0, "spread": 1.02}}
    out = mod.compare_models(old, new)
    assert [out[m]["verdict"] for m in ("alexnet", "inception_bn",
                                        "kaiming")] \
        == ["regression", "ok", "improvement"]
    return out


def _suspect_side(mod, tmp_path):
    out = mod.compare_models(
        {"alexnet": {"value": 20000.0, "suspect": True}},
        {"alexnet": {"value": 700.0, "spread": 1.0}})
    assert out["alexnet"]["verdict"] == "suspect"
    return out


def _recorded_spread(mod, tmp_path):
    out = mod.compare_models(
        {"m": {"value": 1000.0, "spread": 1.4}},
        {"m": {"value": 750.0, "spread": 1.05}})
    assert out["m"]["verdict"] == "ok"
    return out


def _dtype_annotation(mod, tmp_path):
    out = mod.compare_models(
        {"m": {"value": 1000.0, "dtype": "bfloat16"}},
        {"m": {"value": 990.0, "dtype": "int8"}})
    assert (out["m"]["old_dtype"], out["m"]["new_dtype"]) \
        == ("bfloat16", "int8")
    out2 = mod.compare_models({"m": 1000.0}, {"m": {"value": 990.0}})
    assert (out2["m"]["old_dtype"], out2["m"]["new_dtype"]) \
        == ("unknown", "unknown")
    return out, out2


def _dtype_helper(mod, tmp_path):
    old = {"a": {"value": 1.0, "dtype": "float32"},
           "b": {"value": 1.0, "dtype": "bfloat16"},
           "c": {"value": 1.0}}
    assert mod.dtype_mismatches(old, "bfloat16") == [("a", "float32")]
    assert mod.dtype_mismatches(old, "float32") == [("b", "bfloat16")]
    return mod.dtype_mismatches(old, "bfloat16")


def _cross_dtype(name, tmp_path):
    f = tmp_path / "BENCH_f32.json"
    f.write_text(json.dumps({
        "models": {"alexnet": {"value": 9000.0, "dtype": "float32"}}}))
    rc, err = _run(name, ["--compare", str(f)], tmp_path)
    assert rc == 2 and "cannot compare across dtypes" in err
    assert "--allow-dtype-mismatch" in err
    return rc, err.split(": error: ")[1]


def _sync_and_records(mod, tmp_path):
    """The helpers the CLI guards read: sync mismatches, a record's
    corrupt values, a single-model record's own capture fields."""
    old = {"a": {"value": 1.0, "grad_sync": "overlap"},
           "b": {"value": 1.0, "optim_shard": 1}, "c": 5.0}
    out = [mod.sync_mismatches(old, "fused", 0)]
    for rec in ({"models": {"alexnet": {"value": 0.0}}},
                {"value": 12.5, "spread": 1.3, "suspect": False,
                 "dtype": "float32", "metric": "x"}, [1, 2]):
        f = tmp_path / "rec.json"
        f.write_text(json.dumps(rec))
        try:
            out.append(mod.load_compare_record(str(f)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


CASES = {"stable_windows_no_retry": _stable,
         "single_stall_retried_and_recovered": _stall_recovered,
         "compare_rejects_corrupt_record": _corrupt_record,
         "persistent_disagreement_flagged_suspect":
             _persistent_disagreement,
         "injected_sleep_stall_is_retried": _sleep_stall,
         "compare_flags_only_beyond_spread": _beyond_spread,
         "compare_suspect_side_never_verdicts": _suspect_side,
         "compare_respects_recorded_spread_over_floor": _recorded_spread,
         "compare_rows_carry_dtype_annotation": _dtype_annotation,
         "dtype_mismatches_helper": _dtype_helper,
         "compare_refuses_cross_dtype_without_flag": _cross_dtype,
         "sync_mismatches_and_compare_records": _sync_and_records}
# the cases that run each module as a program
BY_NAME = {"compare_rejects_corrupt_record",
           "compare_refuses_cross_dtype_without_flag"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_capture_cases_match(case, tmp_path):
    """test_bench_capture.py's case on both modules: each gives the
    reference's outputs (asserted inside the case) and both give the
    same ones. The timed case's windows differ run to run; its retry
    count and verdict do not."""
    outs = {}
    for name, mod in MODULES.items():
        d = tmp_path / name
        d.mkdir()
        outs[name] = CASES[case](name if case in BY_NAME else mod, d)
    if case == "injected_sleep_stall_is_retried":
        assert outs["bench"] == outs["cxxnet_tpu_torch.bench"]
    else:
        assert json.dumps(outs["bench"], sort_keys=True, default=str) \
            .replace(str(tmp_path / "bench"), "D") \
            == json.dumps(outs["cxxnet_tpu_torch.bench"], sort_keys=True,
                          default=str) \
            .replace(str(tmp_path / "cxxnet_tpu_torch.bench"), "D")


def test_constants_and_models_are_the_reference():
    assert port_bench.STALL_RATIO == ref_bench.STALL_RATIO == 1.5
    assert port_bench.BASELINE_IMAGES_PER_SEC \
        == ref_bench.BASELINE_IMAGES_PER_SEC == 1500.0
    assert port_bench.MODELS == ref_bench.MODELS


def test_one_device_topology_reads_as_the_references():
    """The port's record names one device as the reference's record of
    one device does, so --compare across the packages is not refused
    for it."""
    from cxxnet_tpu.parallel import default_data_axis
    for model, (_, batch, _, _) in port_bench.MODELS.items():
        ref = {"mesh": {"data": default_data_axis(batch, 1), "model": 1},
               "process_count": 1, "device_count": 1}
        assert port_bench.expected_topology(batch) == ref
        old = {model: {"value": 1.0, "topology": ref}}
        assert port_bench.topology_mismatches(old) == []


def _reference_measure_keys():
    """The keys of the reference ``measure()``'s record, read from its
    source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "measure")
    keys = {"mfu"}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict) \
                and getattr(node.targets[0], "id", "") == "out":
            keys |= {k.value for k in node.value.keys}
    return keys


def test_cpu_run_prints_the_reference_records_keys():
    """``python -m cxxnet_tpu_torch.bench --model alexnet --steps 1
    --batch 4 --extra dev=cpu``: the reference's single-model record
    keys (its CLI printed them in test_bench_capture.py's run), the
    capture fields, and a CPU device; ``measure()``'s record has the
    reference's keys too."""
    p = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.bench", "--model",
         "alexnet", "--steps", "1", "--batch", "4", "--extra", "dev=cpu",
         "--peak-tflops", "1"], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr
    rec = json.loads([ln for ln in p.stdout.splitlines()
                      if ln.startswith("{")][-1])
    ref_keys = {"metric", "value", "unit", "vs_baseline", "dt", "spread",
                "suspect", "zero_recompiles", "layout", "dtype",
                "grad_sync", "optim_shard", "mfu"}
    assert ref_keys <= set(rec)
    assert rec["metric"] == "images/sec/chip on ImageNet AlexNet"
    assert len(rec["dt"]) in (2, 3) and rec["spread"] >= 1.0
    assert isinstance(rec["suspect"], bool) and rec["zero_recompiles"]
    assert rec["device"] == "cpu" and rec["peak_mem_gb"] is None
    assert rec["launches_per_step"] == {}
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = port_bench.measure(steps=1, batch=1, model="alexnet",
                                 extra=(("dev", "cpu"),), peak_tflops=1.0)
    finally:
        torch.set_num_threads(before)
    assert _reference_measure_keys() <= set(out)
    assert out["flops_per_img"] > 0 and out["precompile_programs"] == 0


def test_without_a_gpu_the_entry_raises():
    """No ``dev`` pair: the card, and no card here raises; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.measure(steps=1, batch=2, model="kaiming")


@pytest.mark.parametrize("flags", [
    ["--hosts", "1,2"], ["--virtual-devices", "4"],
    ["--hosts-rows", "100"], ["--hosts-batch", "8"],
    ["--grad-sync", "overlap"], ["--grad-sync-bucket-mb", "4"],
    ["--optim-shard", "1"]],
    ids=["hosts", "virtual_devices", "hosts_rows", "hosts_batch",
         "grad_sync", "bucket_mb", "optim_shard"])
def test_multi_gpu_flags_raise_not_ported(flags):
    with pytest.raises(NotPortedError, match="multi-GPU") as e:
        port_bench.main(["--model", "alexnet", "--extra", "dev=cpu"]
                        + flags)
    assert flags[0] in e.value.feature


def test_pipeline_raw_on_the_cpu(tmp_path, monkeypatch):
    """``measure_pipeline`` over raw-tensor records (no JPEG codec) at a
    small size: the reference record's fields; the JPEG mode names what
    it needs where the codec is missing."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rec = port_bench.measure_pipeline(
            batch=2, rec_path=str(tmp_path / "b.rec"), n_images=8,
            raw=True, dispatch_period=2, measure_pure=False,
            extra=(("dev", "cpu"),))
    finally:
        torch.set_num_threads(before)
    assert set(rec) == {"e2e", "duty_cycle", "pure", "eval_ips",
                        "buffer_reuse_rate", "h2d_overlap_ratio",
                        "io_wait_p50_ms", "io_wait_p99_ms",
                        "io_wait_count", "precompile_wall_ms",
                        "precompile_programs"}
    assert rec["e2e"] > 0 and rec["eval_ips"] > 0
    assert os.path.exists(str(tmp_path / "b_raw_8.rec"))
    monkeypatch.setitem(sys.modules, "cv2", None)     # no JPEG codec
    with pytest.raises(RuntimeError, match="cv2"):
        port_bench.measure_pipeline(
            batch=4, rec_path=str(tmp_path / "j.rec"), n_images=4,
            extra=(("dev", "cpu"),))
