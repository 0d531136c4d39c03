"""The port's serving benchmark (``python -m
cxxnet_tpu_torch.tools.serve_bench``) against the reference's
(``tools/serve_bench.py``): the scenarios that boot no process.

Each case runs both tools' ``main(argv)`` in this process on the same
argv, the reference under ``JAX_PLATFORMS=cpu`` and the port with
``--dev cpu``, and holds the printed records to the same keys
(recursively), the same exit code and the same deterministic fields
(request counts, the verdicts, the labels). The exit codes 1 (a compile
event after warmup) and 3 (resident bytes growing point over point) are
forced through one seam in both packages: the module's ``sweep_point``.

``--artifact`` is held against the reference's snapshot boot: the
reference's bundle boot fails on this machine (its
``test_serve_bench_artifact_cold_start_record``), so the port's bundle
column is asserted on its own terms. An export on the CPU seals no
kernel library, so there a bundle boot reads ``artifact_hits`` 0; a
bundle sealing a library reads 1.
"""

import os

import numpy as np
import pytest
import torch

import tools.serve_bench as ref_sb
from cxxnet_tpu_torch.tools import serve_bench as port_sb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONV_CONF = """
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
"""
# the record fields no clock or scheduler moves
DETERMINISTIC = ("requests_ok", "requests_error", "zero_recompiles",
                 "requests_per_client", "buckets", "dtype", "name",
                 "platform", "clients", "request_rows", "mode",
                 "scenario", "generations")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(mod, argv, capsys):
    """``main(argv)`` of one tool: (exit code, the record, stderr)."""
    import json
    argv = list(argv) + (["--dev", "cpu"] if mod is port_sb else [])
    rc = mod.main(argv)
    cap = capsys.readouterr()
    lines = [ln for ln in cap.out.strip().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1]), cap.err


def _keys(obj):
    """The record's key structure: dicts by key, lists by the union of
    their elements' structures."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        out = {}
        for v in obj:
            k = _keys(v)
            if isinstance(k, dict):
                out.update(k)
        return {"[]": out} if out else "[]"
    return None


def _fields(rec, skip=()):
    """The deterministic fields, wherever they sit in the record (but
    the paths in ``skip``)."""
    out = []

    def walk(obj, path):
        if isinstance(obj, dict):
            for k in sorted(obj):
                if k in DETERMINISTIC and path + k not in skip \
                        and not isinstance(obj[k], (dict, list)):
                    out.append((path + k, obj[k]))
                walk(obj[k], path + k + ".")
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                walk(v, "%s%d." % (path, i))

    walk(rec, "")
    return out


def _both(argv, capsys, skip=()):
    ref = _run(ref_sb, argv, capsys)
    port = _run(port_sb, argv, capsys)
    assert port[0] == ref[0], (port[2][-2000:], ref[2][-2000:])
    assert _keys(port[1]) == _keys(ref[1])
    assert _fields(port[1], skip) == _fields(ref[1], skip)
    return ref, port


@pytest.fixture(scope="module")
def conv(tmp_path_factory):
    """The narrow conv + BN net's conf, a float32 snapshot with running
    statistics a fold can use (written by the port), the same snapshot
    calibrated by the port's Calibrator (its ``task = quantize``
    sequence), and its bundle as the port exports it on the CPU."""
    from cxxnet_tpu_torch.artifact import bundle as pb
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet import quantize as pq
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import build_engine
    from cxxnet_tpu_torch.utils.config import parse_config
    d = tmp_path_factory.mktemp("serve_bench_conv")
    conf = str(d / "conv.conf")
    with open(conf, "w") as f:
        f.write(CONV_CONF)
    cfg = parse_config(CONV_CONF)
    rng = np.random.RandomState(0)
    t = NetTrainer(cfg, device="cpu")
    t.init_model()
    t.net_state = {lk: {k: (0.1 * torch.rand(v.shape) if k == "running_exp"
                            else 0.5 + torch.rand(v.shape))
                        for k, v in st.items()}
                   for lk, st in t.net_state.items()}
    f32 = str(d / "0001.model.npz")
    t.save_model(f32)
    cal = pq.Calibrator(t)
    for _ in range(2):
        cal.observe(DataBatch(rng.rand(4, 8, 8, 3).astype(np.float32)))
    t.set_quantization(cal.finish(), {"dtype": "int8", "batches": 2,
                                      "bn_fold_eval": True}, dtype="int8")
    q = str(d / "int8.model.npz")
    t.save_model(q)
    engine = build_engine(cfg, f32, buckets="1,4", device="cpu")
    engine.warmup()
    bundle = str(d / "0001.model.bundle")
    pb.export_bundle(engine, bundle)
    return {"conf": conf, "f32": f32, "int8": q, "bundle": bundle,
            "dir": d}


# -- the closed-loop sweep ------------------------------------------------


@pytest.mark.parametrize("argv", [
    # the reference's own case (tests/test_residency.py:376)
    ["--clients", "1,2", "--requests", "4", "--device-mem"],
    ["--clients", "2", "--requests", "3", "--request-rows", "2",
     "--buckets", "1,4", "--peak-tflops", "1", "--device-mem",
     "--serve-weight-residency", "0"],
], ids=["residency_case", "rows_mfu_legacy"])
def test_sweep_matches_reference(argv, capsys):
    (rc, ref, _), (_, port, _) = _both(argv, capsys)
    assert rc == 0 and port["zero_recompiles"]
    # the synthetic MLP holds fullc weights alone, whose (in, out)
    # layout both packages keep: the same resident bytes
    mem = [p["device_mem_bytes"] for p in port["sweep"]]
    assert mem == [p["device_mem_bytes"] for p in ref["sweep"]]
    # serve_weight_residency = 0 freezes nothing: no resident copy
    legacy = "--serve-weight-residency" in argv
    assert all((b == 0) if legacy else (b > 0) for b in mem)
    if "--peak-tflops" in argv:
        assert all(p["mfu"] > 0 for p in port["sweep"])


def test_int8_sweep_matches_reference(conv, capsys):
    (rc, ref, _), (_, port, _) = _both(
        ["--conf", conv["conf"], "--model-in", conv["int8"],
         "--serve-dtype", "int8", "--clients", "1,2", "--requests", "4",
         "--buckets", "1,4", "--device-mem", "--peak-tflops", "1"], capsys)
    assert rc == 0 and port["dtype"] == "int8"
    # a session from a conf and a snapshot emits model_info: an MFU
    assert all(p["mfu"] > 0 for p in port["sweep"])
    # a frozen conv weight is an OIHW channels-last copy in the port:
    # other bytes than the reference's, the same leak guard
    mem = [p["device_mem_bytes"] for p in port["sweep"]]
    assert mem[0] == mem[1] > 0
    assert all(p["requests_ok"] == p["clients"] * 4 for p in port["sweep"])


def test_artifact_column_against_the_snapshot_boot(conv, capsys):
    argv = ["--conf", conv["conf"], "--model-in", conv["f32"],
            "--clients", "1", "--requests", "4", "--device-mem",
            "--peak-tflops", "1"]
    ref = _run(ref_sb, argv, capsys)
    port = _run(port_sb, argv + ["--artifact", conv["bundle"]], capsys)
    assert port[0] == ref[0] == 0
    keys = _keys(port[1])
    cold = keys.pop("cold_start")
    assert keys == _keys(ref[1])
    art, snap = port[1]["cold_start"]
    # the columns' keys as tools/serve_bench.py:179-194 writes them
    base = {"via", "source", "boot_s", "first_reply_ms",
            "time_to_first_reply_s", "compile_events", "warmup_programs"}
    assert set(cold["[]"]) == base | {"artifact_hits", "artifact_rebuilds",
                                      "fingerprint_match"}
    assert set(snap) == base and art["via"] == "artifact"
    assert (art["artifact_hits"], art["artifact_rebuilds"],
            art["fingerprint_match"], art["compile_events"]) \
        == (0, 0, True, 0)
    assert snap["compile_events"] == 0
    assert art["time_to_first_reply_s"] > 0
    assert port[1]["model"] == conv["bundle"]
    # a session from a bundle emits model_info too
    assert port[1]["sweep"][0]["mfu"] > 0
    assert port[1]["sweep"][0]["requests_ok"] \
        == ref[1]["sweep"][0]["requests_ok"] == 4


def test_artifact_column_counts_a_sealed_library(conv, tmp_path,
                                                 monkeypatch, capsys):
    """A bundle sealing a (synthetic) conv_epilogue library: the boot
    installs it, one hit, no rebuild, no compile."""
    from cxxnet_tpu_torch.artifact import bundle as pb
    from cxxnet_tpu_torch.layers import kernels
    from cxxnet_tpu_torch.serve import build_engine
    from cxxnet_tpu_torch.utils.config import parse_config
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(kernels, "build_info", {})
    so = kernels.library_key("conv_epilogue")[1]
    os.makedirs(str(tmp_path / "_build"))
    with open(so, "wb") as f:
        f.write(b"\x7fELF synthetic conv_epilogue library")
    engine = build_engine(parse_config(CONV_CONF), conv["f32"],
                          buckets="1,4", device="cpu")
    engine.warmup()
    engine.trainer.programs.libraries.add("conv_epilogue")
    bundle = str(tmp_path / "0001.model.bundle")
    assert pb.export_bundle(engine, bundle)["programs"] == 1
    os.remove(so)
    rc, rec, _ = _run(port_sb, ["--artifact", bundle, "--clients", "1",
                                "--requests", "2"], capsys)
    assert rc == 0 and os.path.exists(so)
    (col,) = rec["cold_start"]
    assert (col["artifact_hits"], col["artifact_rebuilds"],
            col["fingerprint_match"], col["compile_events"]) \
        == (1, 0, True, 0)


def test_cold_start_compile_definition(conv, monkeypatch, capsys):
    """The port's compile in the cold-start column: each kernel library
    nvcc builds in the window, and each ``compile`` record of kind
    ``first`` or ``recompile``; the warmup's ``precompile`` records are
    none."""
    from cxxnet_tpu_torch.layers import kernels
    orig = port_sb.build_session

    def build(args, monitor, via=""):
        sess = orig(args, monitor, via=via)
        kernels.nvcc_runs += 2          # two libraries built at the boot
        monitor.emit("compile", kind="first", wall_ms=1.0,
                     signature="late")
        return sess

    monkeypatch.setattr(port_sb, "build_session", build)
    monkeypatch.setattr(kernels, "nvcc_runs", kernels.nvcc_runs)
    rc, rec, err = _run(port_sb, ["--artifact", conv["bundle"],
                                  "--clients", "1", "--requests", "2"],
                        capsys)
    (col,) = rec["cold_start"]
    assert col["compile_events"] == 3 and col["warmup_programs"] == 2
    assert "compiles 3" in err
    # the sweep point counts the libraries built after its warmup
    assert rec["sweep"][0]["compile_events"] == 0 and rc == 0


# -- forced exits through the same seam -----------------------------------


@pytest.mark.parametrize("fault,code", [("compile", 1), ("grow", 3)])
def test_forced_exit_codes_alike(fault, code, monkeypatch, capsys):
    for mod in (ref_sb, port_sb):
        orig = mod.sweep_point

        def sweep_point(args, clients, monitor, sink, _orig=orig):
            pt = _orig(args, clients, monitor, sink)
            if fault == "compile":
                pt["compile_events"] += 1
            else:
                pt["device_mem_bytes"] += clients
            return pt

        monkeypatch.setattr(mod, "sweep_point", sweep_point)
    (rc, ref, err), (_, port, perr) = _both(
        ["--clients", "1,2", "--requests", "2", "--device-mem"], capsys)
    assert rc == code
    assert port["zero_recompiles"] is (fault != "compile")
    if fault == "grow":
        assert "residency leak" in err and "residency leak" in perr


# -- the multi-tenant fleet scenario ----------------------------------------


@pytest.mark.parametrize("slo,code", [("0", 0), ("1e-6", 3)])
def test_tenants_match_reference(slo, code, capsys):
    (rc, ref, _), (_, port, err) = _both(
        ["--tenants", "gold:2,free:2:50:8", "--requests", "6",
         "--slo-p99-ms", slo], capsys,
        # the quota'd tenant's admits follow the clock (asserted below)
        skip=("tenants.1.requests_ok",))
    assert rc == code and port["slo_ok"] is (code == 0)
    for rec in (ref, port):
        gold, free = rec["tenants"]
        assert gold["requests_ok"] == 12 and gold["requests_shed"] == 0
        assert free["requests_ok"] + free["requests_shed"] == 12
        assert free["requests_error"] == 0
    assert "# tenant=gold:" in err


# -- the retrieval scenario -----------------------------------------------


# the forced recall miss: the oracle's ids reversed, patched into the
# package the scenario imports ``oracle_topk`` from
MISS = """
def _miss(pkg):
    orig = pkg.oracle_topk

    def wrong(index, queries, k):
        ids, scores = orig(index, queries, k)
        return ids[:, ::-1], scores

    pkg.oracle_topk = wrong
"""


def _ref_process(argv, prelude=""):
    """The reference tool in a process of its own on one XLA:CPU device
    (``prelude``: code run before it): its bundles do not boot beside the
    eight host devices this test session's conftest makes (the
    reference's own ``test_fleet_serves_embed_and_search_zero_compiles``
    fails alike)."""
    import json
    import subprocess
    import sys
    code = "import sys\n" + prelude + "import tools.serve_bench as sb\n" \
        "sys.exit(sb.main(sys.argv[1:]))\n"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    p = subprocess.run([sys.executable, "-c", code] + list(argv),
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert lines, p.stderr[-3000:]
    return p.returncode, json.loads(lines[-1]), p.stderr


@pytest.mark.parametrize("miss", [False, True], ids=["recall", "miss"])
def test_embed_search_matches_reference(miss, capsys):
    import cxxnet_tpu_torch.retrieval as pr
    argv = ["--embed-search", "--clients", "2", "--requests", "4"]
    rc, ref, _ = _ref_process(argv, MISS + (
        "import cxxnet_tpu.retrieval as r\n_miss(r)\n" if miss else ""))
    ns = {}
    exec(MISS, ns)
    orig = pr.oracle_topk
    try:
        if miss:
            ns["_miss"](pr)
        prc, port, err = _run(port_sb, argv, capsys)
    finally:
        pr.oracle_topk = orig
    assert prc == rc == (3 if miss else 0)
    assert _keys(port) == _keys(ref) and _fields(port) == _fields(ref)
    assert port["recall_at_k"] == ref["recall_at_k"]
    assert (port["recall_at_k"] < 1.0) is miss
    assert port["failed"] == ref["failed"] == 0
    assert [p["ok"] for p in port["scenarios"]] == [8, 8, 8]
    assert "# embed-search: recall@8" in err


# -- usage ----------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--serve-dtype", "int8"],
    ["--serve-dtype", "fp8"],
    ["--serve-dtype", "int4"],
    ["--artifact", "x.bundle", "--tenants", "a:1"],
    ["--replicas", "1", "--tenants", "a:1"],
    ["--generations", "1", "--replicas", "1"],
    ["--generations", "1", "--tenants", "a:1"],
    ["--generations", "1", "--artifact", "x.bundle"],
    ["--autoscale-soak", "5"],
    ["--coalesce-ms", "2"],
    ["--fleet-baseline"],
    ["--balancers", "2", "--replicas", "1"],
    ["--balancers", "2", "--tenants", "a:1"],
    ["--balancers", "2", "--generations", "1"],
    ["--balancers", "2", "--artifact", "x.bundle"],
    ["--embed-search", "--replicas", "1"],
    ["--embed-search", "--tenants", "a:1"],
    ["--embed-search", "--generations", "1"],
    ["--embed-search", "--balancers", "2"],
    ["--embed-search", "--artifact", "x.bundle"],
    ["--requests", "many"],
])
def test_usage_errors_alike(argv, capsys):
    msgs = []
    for mod in (ref_sb, port_sb):
        with pytest.raises(SystemExit) as ei:
            mod.main(argv + (["--dev", "cpu"] if mod is port_sb else []))
        assert ei.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[1]


def test_dev_flag_choices(capsys):
    with pytest.raises(SystemExit) as ei:
        port_sb.main(["--dev", "tpu"])
    assert ei.value.code == 2
    assert "--dev" in capsys.readouterr().err


def test_without_a_gpu_the_tool_raises(monkeypatch):
    """No ``--dev cpu`` and no GPU: raise as ``device.resolve_device``
    does, before any session is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(port_sb, "build_session",
                        lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sb.main(["--clients", "1", "--requests", "1"])
    assert not built
