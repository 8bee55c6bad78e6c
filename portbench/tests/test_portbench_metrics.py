"""The metric arithmetic: rates over whole requests and the whole window,
the 95th percentile of every request, the frozen roofline yardstick, and
the reduction of a device trace."""

import types

import numpy as np
import pytest

from portbench import bench, readers, yardstick
from portbench.trace import WINDOW, Timeline


def _ctx(latencies_ms, window_s, fitter="single", spans=None, steps=10):
    reqs = [types.SimpleNamespace(latency_s=l * 1e-3, walker_steps=steps,
                                  error=None, spans=spans or [])
            for l in latencies_ms]
    cfg = {"fitter": fitter, "nsources": 1, "nwalkers": 250,
           "wave": [100.0, 160.0, 250.0, 350.0, 500.0],
           "model": {"opthin": False, "noalpha": False}}
    traffic = {"nburn": 1500, "nsteps": 8000, "thin": 10}
    return types.SimpleNamespace(requests=reqs, window_s=window_s, cfg=cfg,
                                 traffic=traffic, setup_s=12.5,
                                 timeline=None, cards=[0])


@pytest.mark.parametrize("name", ["walker_steps_per_s",
                                  "walker_steps_per_s.single"])
def test_rate_is_all_work_over_all_time(name):
    ctx = _ctx([100.0] * 7 + [5000.0], 5.7, steps=1000)
    assert bench.reader(name)(ctx) == pytest.approx(8 * 1000 / 5.7)


def test_single_rate_reads_nothing_in_a_catalog_cell():
    ctx = _ctx([100.0] * 3, 1.0, fitter="catalog", steps=1000)
    assert bench.reader("walker_steps_per_s.single")(ctx) is None
    assert bench.reader("walker_steps_per_s")(ctx) == pytest.approx(3000.0)


def test_p95_is_of_every_request():
    lat = list(range(1, 201))
    ctx = _ctx(lat, 30.0)
    assert bench.reader("fit_ms_p95")(ctx) == pytest.approx(
        np.percentile(lat, 95))
    # a catalog cell has no single-fit latency to read
    assert bench.reader("fit_ms_p95")(_ctx(lat, 30.0, "catalog")) is None


def test_span_means_and_their_cells():
    spans = [("run", 0.0, 0.120), ("summary", 0.120, 0.150)]
    ctx = _ctx([150.0] * 3, 1.0, spans=spans)
    assert bench.reader("run_ms.single")(ctx) == pytest.approx(120.0)
    assert bench.reader("summary_ms.single")(ctx) == pytest.approx(30.0)
    assert bench.reader("run_ms.catalog")(ctx) is None
    assert bench.reader("derived_ms.catalog")(ctx) is None
    assert bench.reader("setup_s")(ctx) == 12.5


@pytest.mark.parametrize("icfg,nsrc,nfree,nrec,want_us", [
    ((0, 0, 0, 5, 1), 1, 5, 200, 1.869),          # config 2, K2
    ((0, 0, 0, 5, 1), 256, 5, 20, 478.5),         # config 2, K3
    ((1, 1, 0, 5, 65), 1, 3, 200, 23.94),         # config 3, K2
])
def test_frozen_bounds_match_the_kernel_table(icfg, nsrc, nfree, nrec,
                                              want_us):
    ms, by = yardstick.k2_bound(icfg, nsrc, 250, nfree, 0, 200, nrec)
    assert by == "operations"
    assert ms * 1e3 == pytest.approx(want_us, abs=0.05)


def test_request_bound_sums_the_protocol():
    ctx = _ctx([1.0], 1.0)
    icfg = (0, 0, 0, 5, 1)
    want = sum(yardstick.k2_bound(icfg, 1, 250, 5, 30, s, r)[0]
               for s, r in [(1500, 1500), (1500, 1), (8000, 800)])
    assert readers.request_bound_ms(ctx.cfg, ctx.traffic, 1) == \
        pytest.approx(want)


def _event(cat, name, ts, dur, device=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if device is not None:
        e["args"] = {"device": device}
    return e


def test_timeline_busy_idle_and_labels():
    ev = [_event("user_annotation", WINDOW, 100, 1000),
          _event("user_annotation", "portbench.run", 100, 600),
          _event("user_annotation", "portbench.summary", 700, 400),
          _event("cpu_op", "aten::copy_", 750, 300),
          _event("kernel", "void mbb_stretch_kernel<8, true>(float)", 100,
                 300, 0),
          _event("kernel", "other", 350, 100, 0),    # overlaps: union
          _event("gpu_memcpy", "Memcpy DtoH", 600, 100, 0),
          _event("kernel", "void mbb_stretch_kernel<8, true>(float)", 50,
                 20, 0)]                              # before the window
    tl = Timeline(ev)
    assert tl.window_s == pytest.approx(1e-3)
    assert tl.busy_s(0) == pytest.approx(4.5e-4)
    assert tl.kernel_s(0, readers.K2_KERNEL) == pytest.approx(3e-4)
    gaps = dict(tuple(g) for g in tl.idle_gaps([0]))
    assert gaps == {"run/python": pytest.approx(1.5e-4),
                    "summary/aten::copy_": pytest.approx(4e-4)}
    ops = dict(tuple(o) for o in tl.device_ops([0]))
    assert ops["mbb_stretch_kernel<8, true>"] == pytest.approx(3e-4)


def test_roofline_reads_the_kernel_time():
    ctx = _ctx([1.0, 1.0], 1.0)
    ev = [_event("user_annotation", WINDOW, 0, 10_000_000),
          _event("kernel", "mbb_stretch_kernel<8, true>", 0, 500_000, 0)]
    ctx.timeline = Timeline(ev)
    least = 2 * readers.request_bound_ms(ctx.cfg, ctx.traffic, 1) * 1e-3
    assert bench.reader("k2_roofline_pct")(ctx) == pytest.approx(
        100 * least / 0.5)
    assert bench.reader("device_idle_pct.single")(ctx) == pytest.approx(95.0)
    # no K3 on the card: its reader reads nothing
    assert bench.reader("k3_roofline_pct")(ctx) is None
