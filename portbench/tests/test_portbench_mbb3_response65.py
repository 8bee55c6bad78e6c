"""The configuration mbb3_response65 and its cell response_converged: the
cell resolves to the shape that test_portbench_response.py's config3()
drives on the card, its yardstick is pinned, a CPU window of it passes the
curve reference and fails the point one, and the two readers of the
program's response-mode span and counter (k2_sed_gevals_per_s,
response_pack_ms.single) read the counted ratio, and nothing where the
program recorded nothing."""

import types

import pytest

from portbench import bench, check, harness, program, readers
from portbench.bench import Cell
from portbench.tests.test_portbench_response import (
    RESPONSES, SEED, config3, traffic)
from portbench.trace import WINDOW, Timeline
from portbench.workload import Workload

CELL = "response_converged"
# the keys that describe a configuration file rather than the fit
PROSE = ("source", "deployment", "assumed")
# the frozen k2_bound of one request: the burn (1,500 steps, each
# recorded), the re-burn and production (8,000 steps, 800 records) at
# 5 bands x 65 nodes, 250 walkers, 3 free parameters
BOUND_MS = 1.3105455298507462


def test_the_cell_resolves():
    c = Cell(CELL)
    assert c.entry["config"] == "mbb3_response65" == c.config["name"]
    assert c.entry["traffic"] == "converged" == c.traffic["name"]
    assert c.chips == 1
    # limits no looser than the single cells' own
    single = Cell("single_converged").limits
    assert set(c.limits) == set(single)
    assert all(c.limits[k] <= single[k] for k in single)
    assert [m["name"] for m in c.end_to_end] == [
        "walker_steps_per_s", "fit_ms_p95", "setup_s"]
    # every per-layer metric of single_converged, and the two new ones
    per_layer = {m["name"] for m in c.per_layer}
    assert per_layer == {m["name"] for m in Cell(
        "single_converged").per_layer} | {"response_pack_ms.single"}
    assert {"k2_roofline_pct", "k2_sed_gevals_per_s", "run_ms.single",
            "summary_ms.single"} <= per_layer


def test_the_configuration_is_config3_key_for_key():
    got, want = Cell(CELL).config, config3()
    assert set(got) == set(want)
    for key in sorted(set(want) - set(PROSE)):
        assert got[key] == want[key], key
    assert got["responses"] == RESPONSES
    assert got["reduced"] == {} and got["priors"] == []
    assert got["source"] == {c["name"]: c for c in bench.load_benchmark()[
        "configs"]}["mbb3_response65"]["source"]


def test_request_bound_is_pinned():
    c = Cell(CELL)
    assert readers._icfg(c.config) == (1, 1, 0, 5, 65)
    assert readers.request_bound_ms(c.config, c.traffic, 1) == BOUND_MS


def test_a_cpu_window_passes_the_curve_reference_and_fails_the_point_one():
    """The cell's configuration at 32 walkers and a short chain, driven
    through the workload as the benchmark drives it."""
    cfg = dict(Cell(CELL).config, nwalkers=32)
    tr = traffic("converged", nburn=10, nsteps=20, thin=2)
    tr["check"] = {k: v for k, v in tr["check"].items() if k != "posterior"}
    win = harness.measure(Workload(cfg, tr, device="cpu"), SEED, 0.0,
                          max_requests=2)
    assert not [r.error for r in win.requests if r.error]
    curve = check.judge(win.kept, cfg, tr, SEED)
    assert curve["lnp_gap"] < 1e-3, curve
    assert curve["summary_gap"] < 1e-6, curve
    assert curve["frozen_share"] < 0.2, curve
    point = check.judge(win.kept, {k: v for k, v in cfg.items()
                                   if k != "responses"}, tr, SEED)
    assert point["lnp_gap"] > 1e-3, point


# -- the readers of the program's response-mode span and counter ------------
def _span(name, ms=0.0, counters=None):
    return types.SimpleNamespace(name=name, attrs={}, parent=None, root=0,
                                 start_ns=0, end_ns=round(ms * 1e6),
                                 counters=counters or {})


def _ctx(k2_us, requests=2, fitter="single", traced=True):
    """A traced window of 10 ms with k2_us of K2 on card 0."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
           "dur": 10_000},
          {"ph": "X", "cat": "kernel", "name": "mbb_stretch_kernel<32, true>",
           "ts": 100, "dur": k2_us, "args": {"device": 0}}]
    return types.SimpleNamespace(
        timeline=Timeline(ev) if traced else None, cards=[0],
        cfg={"fitter": fitter},
        requests=[types.SimpleNamespace(error=None)] * requests)


@pytest.fixture
def spans(monkeypatch):
    """Stands `recorded` in for the program's recorder."""
    got = []
    monkeypatch.setattr(program, "recorded", lambda: got or None)
    return got


def test_sed_gevals_is_the_counted_evaluations_over_k2_time(spans):
    spans += [_span("mbb.kernel.k2", counters={"sed_evals": 1_000_000}),
              _span("mbb.kernel.k2", counters={"sed_evals": 3_000_000}),
              _span("mbb.kernel.k1", counters={"sed_evals": 7})]
    got = bench.reader("k2_sed_gevals_per_s")(_ctx(2_000))
    assert got == pytest.approx(4_000_000 / 2e-3 * 1e-9)


def test_response_pack_ms_is_per_completed_request(spans):
    spans += [_span("mbb.fit.response_pack", 0.25),
              _span("mbb.fit.response_pack", 0.15),
              _span("mbb.fit.run", 190.0)]
    ctx = _ctx(2_000, requests=2)
    ctx.requests = ctx.requests + [types.SimpleNamespace(error="failed")]
    got = bench.reader("response_pack_ms.single")(ctx)
    assert got == pytest.approx(0.2)


@pytest.mark.parametrize("case", ["no spans", "no counter", "no K2 time",
                                  "untraced", "catalog"])
def test_sed_gevals_reads_nothing_without_its_inputs(spans, case):
    """The parent program records mbb.kernel.k2 without sed_evals."""
    if case != "no spans":
        spans.append(_span("mbb.kernel.k2", counters=(
            {} if case == "no counter" else {"sed_evals": 5})))
    ctx = _ctx(0 if case == "no K2 time" else 2_000,
               fitter="catalog" if case == "catalog" else "single",
               traced=case != "untraced")
    assert bench.reader("k2_sed_gevals_per_s")(ctx) is None


@pytest.mark.parametrize("case", ["no spans", "point bands", "catalog",
                                  "no request done"])
def test_response_pack_ms_reads_nothing_without_its_spans(spans, case):
    if case != "no spans":
        spans.append(_span("mbb.fit.run" if case == "point bands"
                           else "mbb.fit.response_pack", 0.3))
    ctx = _ctx(2_000, requests=0 if case == "no request done" else 2,
               fitter="catalog" if case == "catalog" else "single")
    assert bench.reader("response_pack_ms.single")(ctx) is None
