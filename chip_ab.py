#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: the redesigned
kernels' times and the main paths' step times of each.

    python3 chip_ab.py [--steps] [--check] [--pipeline] ROOT [ROOT ...]

Each ROOT is a checkout of this repo ("." for this one; a parent commit
unpacked with ``git archive`` into a gitignored directory). The roots
run one after another, each in a process of its own that puts ROOT
first on ``sys.path``, builds ROOT's kernels and imports ROOT's
``chip_smoke.py`` for the main paths' shapes and phases; the timing is
this file's, the same for every root. Give the roots in turns (parent,
change, change, parent) so that a drift of the card shows. Per root:

- ``bias_grad_bf16`` at AlexNet.conf's 8 bias shapes (batch 256) and
  kaiming bf16's 14 (batch 128), and ``torch.sum`` over the same
  cotangents (f32 accumulation: another function's bits, the library
  yardstick); ``pool_concat_fwd`` and ``pool_concat_bwd`` (the pool
  branch's gradient from a dense cotangent) at the tower's fused
  concats, f32 and bf16. Each summed over a step's shapes: device ms
  (torch.profiler's kernel events, the same for the kernel and the
  library call), event ms (CUDA events around back-to-back calls) and
  host ms (the Python time of a call, from perf_counter around calls
  that only queue work);
- ``--steps``: chip_smoke.py's tower, kaiming and AlexNet.conf phases,
  whose step times it prints;
- ``--check``: where ROOT's chip_smoke.py has them, its
  ``bias_grad_extra`` and ``pool_concat_section`` cases (the same bits
  as the plain versions);
- ``--pipeline``: the CLI's training of ``Inception-BN.conf`` (batch
  128, ``bn_pallas = bn_fuse_relu = 1``) and ``AlexNet.conf`` (batch
  256) as shipped, through ROOT's ``python -m cxxnet_tpu_torch.main`` in
  process, on seeded raw-tensor imgrec archives of 768 and 1,536 records
  (six batches a round), 3 rounds each: per round rows/s, the update
  seconds and the rest of the round's window (``data_wait_s``), each
  update's time (host clock to a device sync), the time ``update``
  spends getting its batch onto the card (``_device_batch``, to a
  device sync: the pageable copy where the batch arrives on the host,
  the wait on a staged batch's copy where it arrives staged) and, where
  ROOT stages in the prefetch thread, that thread's copy time a batch;
  in place of the kernel timings above.

Prints the card (``nvidia-smi``) and one JSON line per root, also
written to ``chiprun_out/ab/<i>.json``; exits 1 if a run failed. Needs
one CUDA card and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
ITERS = 10
HOST_CALLS = 40


def _events_ms(fn, iters: int = ITERS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, iters: int = ITERS) -> float:
    """Every kernel ``fn`` launches, from torch.profiler, per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / iters


def _host_ms(fn, calls: int = HOST_CALLS) -> float:
    """The host's time a call, with the card idle at the start and the
    calls' launches (a few each) far from filling its queue."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def _timed(fns, counts):
    """Per-step sums over shapes: {name: {device_ms, ms, host_ms}}."""
    out = {}
    for name in fns[0]:
        out[name] = {key: sum(k * f(fn[name]) for fn, k in zip(fns, counts))
                     for key, f in (("device_ms", _device_ms),
                                    ("ms", _events_ms),
                                    ("host_ms", _host_ms))}
    return out


def _bias(c, kernels, cfg, batch: int):
    import numpy as np
    import torch
    from cxxnet_tpu_torch.nnet.net import FuncNet
    shapes = c.path_bias_shapes(FuncNet(c._configured(cfg), batch), batch)
    uniq = sorted(set(shapes), key=lambda v: -int(np.prod(v)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fns = []
    for sh in uniq:
        dy = (3 * torch.randn(sh, generator=gen, device="cuda")).to(
            torch.bfloat16)
        axes = tuple(range(len(sh) - 1))
        fns.append({"kernel": lambda dy=dy: kernels.bias_grad_bf16(dy),
                    "torch.sum": lambda dy=dy, ax=axes: torch.sum(dy, ax)})
    res = _timed(fns, [shapes.count(sh) for sh in uniq])
    res["launches_per_step"] = len(shapes)
    return res


def _concat(c, kernels, dtype: str):
    import torch
    from cxxnet_tpu_torch.nnet.net import FuncNet
    cfg = c.tower_train_cfg_bf16 if dtype == "bfloat16" \
        else c.tower_train_cfg
    shapes = c.path_concat_shapes(FuncNet(c._configured(cfg(128)), 128), 128)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fns = []
    for widths, pos, k, mode, h, w, b in shapes:
        xs = [(torch.round(2 * torch.randn((b, h, w, ch), generator=gen,
                                           device="cuda")) / 2).to(dt)
              for ch in widths]
        out = kernels.pool_concat_fwd(xs, pos, k, mode)
        dy = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
        fns.append({"fwd": lambda xs=xs, p=pos, k=k, m=mode:
                    kernels.pool_concat_fwd(xs, p, k, m),
                    "bwd": lambda x=xs[pos], o=out, dy=dy,
                    off=sum(widths[:pos]), k=k, m=mode:
                    kernels.pool_concat_bwd(x, o, dy, off, k, m)})
    res = _timed(fns, [1] * len(fns))
    res["launches_per_step"] = len(shapes)
    return res


PIPELINE = (("Inception-BN.conf", 768, 200, ["bn_pallas=1",
                                              "bn_fuse_relu=1"]),
            ("AlexNet.conf", 1536, 256, []))
PIPELINE_ROUNDS = 3


def _pipeline(c, wd: str) -> dict:
    """The CLI's training runs of ``PIPELINE`` through ROOT's
    chip_smoke helpers (``write_cli_archives``, ``shipped_conf``,
    ``tap_trainer``, ``run_cli``)."""
    import torch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    out = {}
    for name, ntrain, nval, keys in PIPELINE:
        tag = name.split(".")[0]
        t0 = time.perf_counter()
        tr, va = c.write_cli_archives(wd, (("%s_t.rec" % tag, ntrain),
                                           ("%s_v.rec" % tag, nval)))
        archives_s = time.perf_counter() - t0
        conf = c.shipped_conf(wd, name, tr, va)
        rec, put_ms = {}, []
        orig = NetTrainer._device_batch

        def timed(self, batch, orig=orig):
            t1 = time.perf_counter()
            res = orig(self, batch)
            torch.cuda.synchronize()
            put_ms.append((time.perf_counter() - t1) * 1e3)
            return res

        NetTrainer._device_batch = timed
        try:
            with c.tap_trainer(rec):
                rc, lines = c.run_cli(
                    [conf, "task=train", "num_round=%d" % PIPELINE_ROUNDS,
                     "print_step=0", "save_model=0",
                     "model_dir=" + os.path.join(wd, tag)] + keys)
        finally:
            NetTrainer._device_batch = orig
        ms = [u["ms"] for u in rec["updates"]]
        per = -(-ntrain // (128 if tag.startswith("Inception") else 256))
        rounds = []
        for i, rd in enumerate(rec["rounds"]):
            upd = sum(ms[i * per:(i + 1) * per]) / 1e3
            r = {"rows_per_s": rd["rows_per_s"], "wall_s": rd["wall_s"],
                 "update_s": upd, "data_wait_s": rd["wall_s"] - upd}
            if rd.get("h2d_batches"):
                r["prefetch_h2d_ms_per_batch"] = \
                    rd["h2d_ms"] / rd["h2d_batches"]
            rounds.append(r)
        out[tag] = {"rc": rc, "archives_s": archives_s, "rounds": rounds,
                    "updates_ms": ms, "first_update_ms": ms[0] if ms
                    else None, "update_median_ms": _median(ms[1:]),
                    "device_batch_ms": put_ms,
                    "device_batch_median_ms": _median(put_ms[1:]),
                    "staged": sum(u.get("staged", False)
                                  for u in rec["updates"])}
        for path in (tr, va):
            os.remove(path)
        torch.cuda.empty_cache()
    return out


def _median(v):
    v = sorted(v)
    return v[len(v) // 2] if v else None


def run_one(root: str, steps: bool, check: bool,
            pipeline: bool = False) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import tempfile
    import torch
    import chip_smoke as c
    from cxxnet_tpu_torch.device import resolve_device
    from cxxnet_tpu_torch.layers import kernels
    resolve_device("cuda")
    t0 = time.perf_counter()
    kernels.build_kernels()
    out = {"root": root, "build_s": time.perf_counter() - t0}
    if not pipeline:
        out.update(
            bias_alexnet=_bias(c, kernels, c.alexnet_cfg(c.ALEX_BATCH),
                               c.ALEX_BATCH),
            bias_kaiming=_bias(c, kernels, c.kaiming_cfg_bf16(128), 128),
            concat_float32=_concat(c, kernels, "float32"),
            concat_bfloat16=_concat(c, kernels, "bfloat16"))
    ok = True
    if pipeline:
        out["pipeline"] = _pipeline(c, tempfile.mkdtemp(prefix="chip_ab_"))
        ok = all(r["rc"] == 0 for r in out["pipeline"].values())
    bw, flops, _ = c.card_peaks(torch.cuda.get_device_name(0))
    if check and hasattr(c, "bias_grad_extra"):
        ex = c.bias_grad_extra(bw, flops)
        pc = [c.pool_concat_section(bw, flops, dt)
              for dt in ("float32", "bfloat16")]
        out["check"] = {
            "bias_extra": [[x["tag"], x["ok"], x["routes"]]
                           for x in ex["cases"]],
            "concat_extra": [[x["widths"], x["k"], x["mode"], x["hw"],
                              x["dtypes"], x["ok"], x.get("bwd_plan")]
                             for s in pc for x in s["extra_cases"]],
            "concat_path": [[x["widths"], x["mode"], x["dtype"], x["ok"],
                             x.get("bwd_plan")]
                            for s in pc for x in s["path_cases"]],
            "ok": ex["ok"] and all(s["ok"] for s in pc)}
        ok = out["check"]["ok"]
    if steps:
        wd = tempfile.mkdtemp(prefix="chip_ab_")
        tw = c.phase_tower(wd)
        km = c.phase_train_kaiming(wd)
        ax = c.phase_alexnet(wd, bw)
        busy = lambda r: r.get("profile", {}).get("device_busy_ms")  # noqa
        out["steps"] = {
            "tower_f32_ms": tw["train"]["step_ms"],
            "tower_bf16_ms": tw["train_bf16"]["step_ms"],
            "tower_serve_fwd128_ms": tw["serve"]["fwd128_ms"],
            "kaiming_f32_ms": km["step_ms"],
            "kaiming_bf16_ms": km["bf16"]["step_ms"],
            "kaiming_bf16_busy_ms": busy(km["bf16"]),
            "alexnet_update_median_ms": _median(ax["train"]["step_ms"][1:]),
            "alexnet_updates_ms": ax["train"]["step_ms"]}
        ok = ok and tw["ok"] and km["ok"] and ax["ok"]
    out["ok"] = ok
    return out


def main(argv) -> int:
    steps, check = "--steps" in argv, "--check" in argv
    pipeline = "--pipeline" in argv
    roots = [a for a in argv if not a.startswith("--")]
    if "--one" in argv:
        res = run_one(roots[0], steps, check, pipeline)
        print("AB " + json.dumps(res), flush=True)
        return 0 if res["ok"] else 1
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    outdir = os.path.join(HERE, "chiprun_out", "ab")
    os.makedirs(outdir, exist_ok=True)
    rc = 0
    for i, root in enumerate(roots):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root] + [a for a in argv
                                              if a.startswith("--")],
                           capture_output=True, text=True, timeout=1800)
        lines = [ln[3:] for ln in p.stdout.splitlines()
                 if ln.startswith("AB ")]
        with open(os.path.join(outdir, "%d.json" % i), "w") as f:
            f.write(lines[-1] if lines else "")
        with open(os.path.join(outdir, "%d.log" % i), "w") as f:
            f.write(p.stdout + p.stderr)
        print(i, root, "rc=%d" % p.returncode, flush=True)
        if lines:
            print(lines[-1], flush=True)
        else:
            print(p.stderr[-3000:], flush=True)
        rc = rc or p.returncode
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
