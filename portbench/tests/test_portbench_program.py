"""The readers of the program's own spans (portbench/program.py) on
hand-built timelines: the clock offset from the harness's spans, idle
intervals split exactly by overlap and by the innermost span, per layer of
each span's root, and every reader silent where it has nothing to read."""

import types

import pytest

from portbench import bench, program
from portbench.bench import Cell
from portbench.trace import WINDOW, Timeline

OFF_US = 7_000_000.0          # the trace's clock = perf_counter us + OFF_US
NEW = ["protocol_idle_ms.single", "protocol_idle_ms.catalog",
       "results_idle_ms.single", "results_idle_ms.catalog",
       "derived_idle_ms.catalog", "derived_idle_ms.single", "d2h_mb.single",
       "d2h_mb.catalog"]
B = bench.load_benchmark()
LISTED = {m["name"]: m["workloads"] for m in B["per_layer"]}


def _event(cat, name, ts, dur, device=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if device is not None:
        e["args"] = {"device": device}
    return e


def _span(name, a_us, b_us, parent=None, root=None, counters=None):
    """A recorded span at a_us..b_us of the trace's clock."""
    return types.SimpleNamespace(
        name=name, attrs={}, parent=parent, root=root,
        start_ns=round((a_us - OFF_US) * 1e3),
        end_ns=round((b_us - OFF_US) * 1e3), counters=counters or {})


def _ctx(harness, busy, fitter="single", derived=(), jitter=None, cards=1,
         lag=0.0):
    """A traced run's context: the harness's spans [(name, a, b)] in trace
    us (one request each run span starts; its clock `lag` us wider on each
    side than the annotation, plus `jitter`), device activity [(a, b)] on
    every card, a 0..10,000 us window."""
    ev = [_event("user_annotation", WINDOW, 0, 10_000)]
    reqs, jitter = [], jitter or [0.0] * len(harness)
    for (name, a, b), j in zip(harness, jitter):
        ev.append(_event("user_annotation", f"portbench.{name}", a, b - a))
        if name == "run":
            reqs.append(types.SimpleNamespace(error=None, spans=[]))
        reqs[-1].spans.append((name, (a - lag - OFF_US + j) * 1e-6,
                               (b + lag - OFF_US + j) * 1e-6))
    for c in range(cards):
        ev += [_event("kernel", "k", a, b - a, c) for a, b in busy]
    return types.SimpleNamespace(
        timeline=Timeline(ev), requests=reqs, cards=list(range(cards)),
        cfg={"fitter": fitter}, traffic={"derived": list(derived)})


@pytest.fixture
def spans(monkeypatch):
    """Stands `recorded` in for the program's recorder."""
    got = []
    monkeypatch.setattr(program, "recorded", lambda: got or None)
    return got


@pytest.mark.parametrize("lag", [0.0, 12.0])
def test_clock_offset_from_the_harness_spans(lag):
    """The median of the spans' midpoint differences, and the largest
    distance from it; a lag of the annotations inside the harness's own
    clock on both sides cancels."""
    harness = [("run", 100, 400), ("summary", 400, 500), ("run", 600, 900),
               ("summary", 900, 990)]
    ctx = _ctx(harness, [], jitter=[0.0, 3.0, -2.0, 1.0], lag=lag)
    off, residual = program.clock_offset(ctx)
    assert off == pytest.approx(OFF_US - 0.5, abs=1e-3)
    assert residual == pytest.approx(2.5, abs=1e-3)


def test_clock_offset_refuses_spans_that_do_not_pair():
    ctx = _ctx([("run", 100, 400), ("summary", 400, 500)], [])
    ctx.requests[0].spans.pop()
    assert program.clock_offset(ctx) is None


def test_idle_straddling_two_spans_is_split_exactly(spans):
    ctx = _ctx([("run", 0, 600), ("summary", 600, 1000)],
               [(0, 100), (900, 10_000)])
    spans += [_span("mbb.fit.run", 50, 500, root=0),
              _span("mbb.results.load", 500, 950, root=1)]
    got = program.split(ctx)
    assert got["layers"] == {"fit protocol": pytest.approx(0.4),
                             "results": pytest.approx(0.4)}
    assert got["unattributed"] == pytest.approx(0.0, abs=1e-9)
    assert got["idle"] == pytest.approx(0.8)
    assert got["harness_idle"] == pytest.approx(0.8)
    assert got["harness_attributed"] == pytest.approx(1.0)
    assert got["residual_us"] == pytest.approx(0.0, abs=1e-3)
    assert program.idle_ms(ctx, "single", "results") == pytest.approx(0.4)


def test_nested_spans_go_to_the_innermost(spans):
    ctx = _ctx([("run", 0, 1000)], [(400, 10_000)])
    spans += [_span("mbb.fit.run", 0, 1000, root=0),
              _span("mbb.fit.burn", 100, 300, parent=0, root=0),
              _span("mbb.kernel.k2", 150, 250, parent=1, root=0),
              _span("mbb.fit.recentre", 300, 350, parent=0, root=0)]
    got = program.split(ctx)
    assert got["steps"] == {"mbb.fit.run": pytest.approx(0.15),
                            "mbb.fit.burn": pytest.approx(0.1),
                            "mbb.kernel.k2": pytest.approx(0.1),
                            "mbb.fit.recentre": pytest.approx(0.05)}
    # every piece goes to the layer of the root
    assert got["layers"] == {"fit protocol": pytest.approx(0.4)}


def test_layers_and_the_remainder_add_up_to_the_idle_time(spans):
    """Two requests on two cards: per request and per card; what no span
    covers (between requests, the harness's own code) is unattributed."""
    harness = [("run", 0, 1000), ("derived", 1000, 3000),
               ("run", 5000, 6000), ("derived", 6000, 8000)]
    ctx = _ctx(harness, [(200, 800), (5200, 5800)], fitter="catalog",
               derived=["lir"], cards=2)
    for a in (0, 5000):
        i = len(spans)
        spans += [_span("mbb.fit.run", a + 10, a + 990, root=i),
                  _span("mbb.derived.lir", a + 1000, a + 2900, root=i + 1),
                  _span("mbb.derived.chunk", a + 1100, a + 1200,
                        parent=i + 1, root=i + 1,
                        counters={"d2h_bytes": 3_000_000})]
    got = program.split(ctx)
    assert got["idle"] == pytest.approx(4.4)      # 8,800 us a card, 2 requests
    assert sum(got["layers"].values()) + got["unattributed"] == \
        pytest.approx(got["idle"])
    assert got["layers"]["fit protocol"] == pytest.approx(0.38)
    assert got["layers"]["derived posteriors"] == pytest.approx(1.9)
    assert got["steps"]["mbb.derived.chunk"] == pytest.approx(0.1)
    assert got["harness_idle"] == pytest.approx(2.4)
    assert got["harness_attributed"] == pytest.approx(2.28 / 2.4)
    assert got["spans"] == 3
    assert bench.reader("derived_idle_ms.catalog")(ctx) == \
        pytest.approx(1.9)
    assert bench.reader("d2h_mb.catalog")(ctx) == pytest.approx(3.0)


@pytest.mark.parametrize("derived", [["lir", "dustmass", "peaklambda"], []])
def test_single_derived_idle_reads_the_derived_spans(spans, derived):
    """A single fit's idle under MBBResults' mbb.derived.* roots (each
    compute_* with its distance and chunk, each *_cen summary) is the
    derived layer's; a mix without derived quantities reads nothing."""
    harness = [("run", 0, 1000), ("summary", 1000, 1500),
               ("derived", 1500, 4000)]
    ctx = _ctx(harness, [(100, 900), (2000, 2200), (3000, 3100)],
               derived=derived)
    spans += [_span("mbb.fit.run", 10, 990, root=0),
              _span("mbb.results.load", 1000, 1200, root=1),
              _span("mbb.results.percentiles", 1200, 1490, root=2),
              _span("mbb.derived.lir", 1500, 2500, root=3),
              _span("mbb.derived.distance", 1600, 1700, parent=3, root=3),
              _span("mbb.derived.chunk", 1900, 2300, parent=3, root=3,
                    counters={"d2h_bytes": 500_000}),
              _span("mbb.derived.summary", 2500, 2600, root=6),
              _span("mbb.derived.peaklambda", 2600, 3900, root=7)]
    got = bench.reader("derived_idle_ms.single")(ctx)
    if not derived:
        assert got is None
        return
    # idle 1500-2000 and 2200-3000 and 3100-3900 us, all under the roots
    assert got == pytest.approx(2.1)
    assert program.split(ctx)["steps"]["mbb.derived.distance"] == \
        pytest.approx(0.1)
    assert bench.reader("results_idle_ms.single")(ctx) == pytest.approx(0.49)
    assert bench.reader("derived_idle_ms.catalog")(ctx) is None


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
@pytest.mark.parametrize("metric", NEW)
def test_each_reader_reads_only_the_cells_it_lists(metric, cell, spans):
    c = Cell(cell)
    ctx = _ctx([("run", 0, 1000), ("summary", 1000, 1200)]
               + ([("derived", 1200, 3000)] if c.traffic["derived"] else []),
               [(100, 900)], fitter=c.config["fitter"],
               derived=c.traffic["derived"])
    spans += [_span("mbb.fit.run", 0, 990, root=0,
                    counters={"d2h_bytes": 10}),
              _span("mbb.results.percentiles", 1000, 1190, root=1),
              _span("mbb.derived.lir", 1200, 2990, root=2)]
    value = bench.reader(metric)(ctx)
    if cell in LISTED[metric]:
        assert value is not None and value > 0
    else:
        assert value is None


@pytest.mark.parametrize("metric", NEW)
def test_readers_are_silent_without_the_recorder(metric, spans,
                                                 monkeypatch):
    """A program without the recorder, or an untraced run, gives every
    new reader nothing to read."""
    ctx = _ctx([("run", 0, 1000), ("summary", 1000, 1200),
                ("derived", 1200, 3000)], [(100, 900)],
               fitter=metric.rsplit(".", 1)[1], derived=["lir"])
    assert bench.reader(metric)(ctx) is None          # nothing recorded
    from mbb_emcee_tpu_torch.utils import profiling
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "recorded")
    assert program.recorded() is None
    assert bench.reader(metric)(ctx) is None
    if not metric.startswith("d2h"):
        ctx.timeline = None
        assert bench.reader(metric)(ctx) is None
