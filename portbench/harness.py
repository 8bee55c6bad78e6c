"""One run of one cell: set-up, the measured window, the check, the result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up loads the port, builds its kernels on a checkout's first run, and
sends one warm-up request of the cell's own shape. The window then runs a
closed loop with one client: the next request goes out when the last has
returned, and the window closes when the request in flight at `--seconds`
completes. After the window the peak memory is read, the port's state is
freed, and the kept requests are judged by the plain reference (check.py).
The last line of standard output is the result, in the benchmark
contract's form; the numbers compared stand beside their limits in it and
as the last lines of standard error.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import types

import numpy as np

from portbench import check, mockdata
from portbench.bench import Cell, reader
from portbench.workload import Spans, Workload, left_kernels, read_counters

FORBIDDEN = ("jax", "jaxlib", "flax", "mbb_emcee_tpu")


def log(msg):
    print(msg, flush=True)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return ", ".join(out.stdout.split("\n")).strip(", ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules():
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (mbb_emcee_tpu_torch is not mbb_emcee_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of k of the window's requests, drawn from the
    seed as they come (reservoir sampling): kept[slot] = (index, items)."""

    def __init__(self, k, seed):
        self.k = int(k)
        self.g = mockdata.rng(seed, 3)
        self.kept = []

    def slot(self, i):
        if i < self.k:
            return i
        j = int(self.g.integers(0, i + 1))
        return j if j < self.k else None

    def put(self, slot, index, items):
        if slot == len(self.kept):
            self.kept.append((index, items))
        else:
            self.kept[slot] = (index, items)


def measure(work, seed, seconds, trace=False, max_requests=None):
    """The measured window: requests until `seconds` have passed (and the
    request in flight has returned) or `max_requests` have run."""
    import torch
    from portbench import trace as tracing
    res = Reservoir(work.traffic["check"]["requests"][work.fitter], seed)
    requests = []
    prof = None
    if trace:
        prof = tracing.start()
        torch.cuda.synchronize()
    win = (torch.profiler.record_function(tracing.WINDOW) if trace
           else None)
    if win is not None:
        win.__enter__()
    t_open = time.perf_counter()
    i = 0
    while True:
        spans = Spans(sync=trace, annotate=trace)
        c0 = read_counters()
        err, acc, extract = None, math.nan, None
        t0 = time.perf_counter()
        try:
            with spans("request"):
                acc, extract = work.run(seed, i, spans)
        except Exception as exc:        # a failed request is counted
            err = f"{type(exc).__name__}: {exc}"
        t1 = time.perf_counter()
        c1 = read_counters()
        requests.append(types.SimpleNamespace(
            index=i, t0=t0, t1=t1, latency_s=t1 - t0, spans=spans.spans,
            walker_steps=0 if err else work.walker_steps, acceptance=acc,
            launches={k: c1[k] - c0[k] for k in c0}, error=err))
        if extract is not None:
            s = res.slot(i)
            if s is not None:
                res.put(s, i, extract(seed, i))
        extract = None
        i += 1
        if time.perf_counter() - t_open >= seconds:
            break
        if max_requests is not None and i >= max_requests:
            break
    t_close = time.perf_counter()
    if win is not None:
        win.__exit__(None, None, None)
    timeline = tracing.finish(prof) if trace else None
    return types.SimpleNamespace(requests=requests, kept=res.kept,
                                 t_open=t_open, t_close=t_close,
                                 window_s=t_close - t_open,
                                 timeline=timeline)


def peak_memory(cards):
    import torch
    return max(int(torch.cuda.max_memory_allocated(c)) for c in cards)


def judge(cell, work, win, seed, control=None, device="cpu",
          require_kernels=True):
    """{name: (value, limit)} of every number compared."""
    numbers = check.judge(win.kept, cell.config, cell.traffic, seed,
                          mode="port" if control is None else control,
                          device=device)
    off = sum(1 for r in win.requests if r.error is None
              and left_kernels(work.fitter, r.launches)) if require_kernels \
        else 0
    out = {"failed": (sum(1 for r in win.requests if r.error), 0),
           "off_kernel": (off, 0),
           "kept": (len(win.kept), None)}
    for name, value in numbers.items():
        out[name] = (value, cell.limits.get(name))
    return out


def is_correct(checks):
    ok = True
    for name, (value, limit) in checks.items():
        if name == "kept":
            ok = ok and value > 0
            continue
        ok = ok and limit is not None and value <= limit
    return ok


def metrics_of(cell, ctx, trace):
    out = {}
    for m in cell.metrics(trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def summary_lines(win):
    lat = np.array([r.latency_s for r in win.requests]) * 1e3
    log(f"window: {len(win.requests)} requests in {win.window_s:.6f} s; "
        f"latency ms first {lat[0]:.3f} median {np.median(lat):.3f} "
        f"max {lat.max():.3f}; kept {[k for k, _ in win.kept]}")
    keys = sorted(win.requests[0].launches)
    rng_ = {k: (min(r.launches[k] for r in win.requests),
                max(r.launches[k] for r in win.requests)) for k in keys}
    log("launches per request: " + ", ".join(
        f"{k} {a}-{b}" for k, (a, b) in rng_.items()))
    errs = [r.error for r in win.requests if r.error]
    if errs:
        log(f"failed requests: {len(errs)}; first: {errs[0]}")


def main(args, t_start):
    import torch
    t_torch = time.perf_counter()
    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device: this benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    cards = list(range(cell.chips))
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()} (using {cell.chips}); "
        f"power.limit {power_limit()}")
    log(f"cell {cell.name}: config {cell.entry['config']}, traffic "
        f"{cell.entry['traffic']}, seed {args.seed}, seconds {args.seconds}, "
        f"trace {args.trace}")

    t_card = time.perf_counter()
    from mbb_emcee_tpu_torch.ops.build import build_kernels
    build_kernels()
    t_lib = time.perf_counter()
    work = Workload(cell.config, cell.traffic, device="cuda")
    # warm-up: one request of the cell's shape
    warm = Spans(sync=False, annotate=False)
    work.run(args.seed, -1, warm)
    torch.cuda.synchronize()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    log(f"set-up {setup_s:.6f} s")
    log(f"set-up phases s: import torch {t_torch - t_start:.3f}, card "
        f"{t_card - t_torch:.3f}, kernel library {t_lib - t_card:.3f}, "
        f"warm-up request {t_warm - t_lib:.3f} (" + ", ".join(
            f"{n} {b - a:.3f}" for n, a, b in warm.spans) + ")")

    win = measure(work, args.seed, args.seconds, trace=bool(args.trace))
    summary_lines(win)
    for c in cards:
        torch.cuda.synchronize(c)
    peak = peak_memory(cards)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad} after the window",
              file=sys.stderr)
        return 3

    ctx = types.SimpleNamespace(cell=cell, cfg=cell.config,
                                traffic=cell.traffic, work=work,
                                requests=win.requests, window_s=win.window_s,
                                setup_s=setup_s, timeline=win.timeline,
                                cards=cards)
    metrics = metrics_of(cell, ctx, bool(args.trace))
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": peak}
    result = {"attempted": len(win.requests),
              "failed": sum(1 for r in win.requests if r.error),
              "metrics": metrics, "device": device}
    if args.trace:
        tl = win.timeline
        device["busy_s"] = float(np.mean([tl.busy_s(c) for c in cards]))
        device["window_s"] = tl.window_s
        result["breakdown"] = {"device_ops": tl.device_ops(cards),
                               "idle_gaps": tl.idle_gaps(cards)}
    # the port's state is freed before the reference runs
    win.timeline = None
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = judge(cell, work, win, args.seed, control=args.control,
                   device="cuda")
    log(f"reference check {time.perf_counter() - t_ref:.3f} s")
    result["correct"] = is_correct(checks)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    for n, (v, lim) in checks.items():
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks"]
    print(json.dumps({k: result[k] for k in order if k in result}),
          flush=True)
    return 0
