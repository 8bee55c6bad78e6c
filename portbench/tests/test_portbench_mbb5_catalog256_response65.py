"""The configuration mbb5_catalog256_response65 and its cell
catalog_response_converged: the cell resolves with one chip, the
configuration is mbb5_catalog256 key for key with mbb3_response65's curves
added, its limits are no looser than catalog_converged's, its yardstick
and K3's plan at its shape are pinned, the plain reference holds the
full model through the curves (a CPU window passes the curve reference and
fails the point one), and the reader of K3's counted SED
evaluations (k3_sed_gevals_per_s) reads the counted ratio, and nothing
where the program recorded nothing. The `cuda` case drives the cell's
shape on the card and judges its kept requests against the curve
reference, which they pass, and the point one, which they fail."""

import json
import types

import pytest

from portbench import bench, check, harness, program, readers
from portbench.bench import Cell
from portbench.tests.test_portbench_response import (
    RESPONSES, SEED, _catalog, _window, traffic)
from portbench.trace import WINDOW, Timeline
from portbench.workload import Workload

CELL = "catalog_response_converged"
CONFIG = "mbb5_catalog256_response65"
# the keys that describe a configuration file rather than the fit
PROSE = ("name", "source", "deployment", "assumed", "reduced")
# the frozen k2_bound of one request: the burn (1,500 steps, one record),
# the re-burn and production (8,000 steps, 800 records) at 5 bands x 65
# nodes, 256 sources x 250 walkers, 5 free parameters
BOUND_MS = 567.6938297313433


def test_the_cell_resolves():
    c = Cell(CELL)
    assert c.entry["config"] == CONFIG == c.config["name"]
    assert c.entry["traffic"] == "converged" == c.traffic["name"]
    assert c.chips == 1
    # limits no looser than catalog_converged's own
    point = Cell("catalog_converged")
    assert set(c.limits) == set(point.limits)
    assert all(c.limits[k] <= point.limits[k] for k in point.limits)
    assert [m["name"] for m in c.end_to_end] == [
        "walker_steps_per_s", "setup_s"]
    # every per-layer metric of catalog_converged, which now also reads
    # K3's SED evaluations
    per_layer = {m["name"] for m in c.per_layer}
    assert per_layer == {m["name"] for m in point.per_layer}
    assert {"k3_roofline_pct", "k3_sed_gevals_per_s", "run_ms.catalog",
            "device_idle_pct.catalog"} <= per_layer
    assert not {"k2_roofline_pct", "derived_ms.catalog"} & per_layer


def test_the_configuration_is_the_catalog_with_the_curves():
    got = Cell(CELL).config
    want = Cell("catalog_converged").config
    assert set(got) == set(want) | {"responses"}
    for key in sorted(set(want) - set(PROSE)):
        assert got[key] == want[key], key
    assert got["responses"] == RESPONSES == Cell(
        "response_converged").config["responses"]
    assert got["model"] == {"opthin": False, "noalpha": False,
                            "wavenorm": 500.0}
    assert set(got["reduced"]) == {"nsources"}
    assert set(got["assumed"]) == set(want["assumed"]) | {"responses"}
    entry = {c["name"]: c for c in bench.load_benchmark()["configs"]}[CONFIG]
    assert got["source"] == entry["source"]
    assert entry["reduced"] == ["nsources"]


def test_request_bound_is_pinned():
    c = Cell(CELL)
    assert readers._icfg(c.config) == (0, 0, 0, 5, 65)
    assert readers.request_bound_ms(c.config, c.traffic, 256) == BOUND_MS


@pytest.mark.parametrize("model", [dict(noalpha=False, opthin=False),
                                   dict(noalpha=True, opthin=True)],
                         ids=["full", "thin"])
def test_k3_plan_at_the_cells_shape_is_pinned(model):
    """5 bands x 65 nodes, 125 walkers a half, 256 sources: G = 4 lanes a
    walker in one block of 512 threads a source, which the H100 model
    holds in one wave of 264 sources, for either model."""
    from mbb_emcee_tpu_torch.ops.multifit_kernel import (
        h100_resident, plan_multi_launch)
    from mbb_emcee_tpu_torch.ops.sampler_kernel import stretch_plan
    plan = plan_multi_launch(5, 65, 125, 256, **model)
    assert plan == stretch_plan(4, 1, 5, 65, 125)
    assert (plan.walkers_per_block, plan.threads, plan.smem_bytes) == \
        (125, 512, 20228)
    assert h100_resident(plan) == 264


def full5(nwalkers):
    """mbb5_single's full five-parameter MBB (thick dust, free lambda0,
    the Wien power law merged at alpha) with its priors on lambda0 and
    alpha, each band's flux the quadrature over its filter curve."""
    cfg = json.loads(json.dumps(Cell("single_converged").config))
    cfg.update(name="mbb5_response65", nwalkers=nwalkers,
               responses=RESPONSES)
    return cfg


@pytest.mark.parametrize("fitter", ["single", "catalog"])
def test_the_full_model_passes_the_curve_reference_and_fails_the_point_one(
        fitter):
    """The plain reference holds the full model through the curves, as
    test_portbench_response.py's twin holds the thin one: a single fit,
    and a catalog of four sources with a missing band, at 32 walkers."""
    cfg = full5(nwalkers=32)
    if fitter == "catalog":
        cfg = _catalog(cfg)
    tr = traffic("converged", nburn=10, nsteps=20, thin=2)
    tr["check"] = {k: v for k, v in tr["check"].items() if k != "posterior"}
    tr["check"]["sources"] = 2
    win = _window(cfg, tr, 2)
    assert not [r.error for r in win.requests if r.error]
    curve = check.judge(win.kept, cfg, tr, SEED)
    assert curve["lnp_gap"] < 1e-3, curve
    assert curve["summary_gap"] < 1e-6, curve
    point_cfg = {k: v for k, v in cfg.items() if k != "responses"}
    point = check.judge(win.kept, point_cfg, tr, SEED)
    assert point["lnp_gap"] > 1e-3, point


# -- the reader of K3's counted SED evaluations -------------------------------
def _span(name, counters=None):
    return types.SimpleNamespace(name=name, attrs={}, parent=None, root=0,
                                 start_ns=0, end_ns=0,
                                 counters=counters or {})


def _ctx(k3_us, fitter="catalog", traced=True):
    """A traced window of 10 ms with k3_us of K3 on card 0."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
           "dur": 10_000},
          {"ph": "X", "cat": "kernel",
           "name": "mbb_multi_stretch_kernel<4, false>", "ts": 100,
           "dur": k3_us, "args": {"device": 0}}]
    return types.SimpleNamespace(
        timeline=Timeline(ev) if traced else None, cards=[0],
        cfg={"fitter": fitter},
        requests=[types.SimpleNamespace(error=None)] * 2)


@pytest.fixture
def spans(monkeypatch):
    """Stands `recorded` in for the program's recorder."""
    got = []
    monkeypatch.setattr(program, "recorded", lambda: got or None)
    return got


def test_sed_gevals_is_the_counted_evaluations_over_k3_time(spans):
    spans += [_span("mbb.kernel.k3", {"sed_evals": 5_000_000}),
              _span("mbb.kernel.k3", {"sed_evals": 3_000_000}),
              _span("mbb.kernel.k2", {"sed_evals": 7}),
              _span("mbb.kernel.k1", {"sed_evals": 11})]
    got = bench.reader("k3_sed_gevals_per_s")(_ctx(4_000))
    assert got == pytest.approx(8_000_000 / 4e-3 * 1e-9)


@pytest.mark.parametrize("case", ["no spans", "no counter", "no K3 time",
                                  "untraced", "single"])
def test_sed_gevals_reads_nothing_without_its_inputs(spans, case):
    if case != "no spans":
        spans.append(_span("mbb.kernel.k3", (
            {} if case == "no counter" else {"sed_evals": 5})))
    ctx = _ctx(0 if case == "no K3 time" else 2_000,
               fitter="single" if case == "single" else "catalog",
               traced=case != "untraced")
    assert bench.reader("k3_sed_gevals_per_s")(ctx) is None


# -- on the card ---------------------------------------------------------------
@pytest.mark.cuda
def test_the_cell_on_the_card(card):
    """The cell's configuration at the converged depth on the card, a
    window of the check's three requests: 3 K3 launches a request and no
    plain sampler, the layout K3 launched, the kept requests within the
    curve reference's limits and beyond the point reference's lnp_gap.
    Prints the readings as one JSON line (run with -s)."""
    import torch
    from mbb_emcee_tpu_torch.utils import profiling
    c = Cell(CELL)
    work = Workload(c.config, c.traffic, device="cuda")
    work.run(SEED, -1, harness.Spans(False, False))
    torch.cuda.synchronize()
    requests = c.traffic["check"]["requests"]["catalog"]
    n0 = len(profiling.recorded())
    win = harness.measure(work, SEED, 1e9, trace=True,
                          max_requests=requests)
    assert not [r.error for r in win.requests if r.error]
    for r in win.requests:
        assert r.launches["k3"] == 3
        assert not any(r.launches[k] for k in ("plain", "plain_multi",
                                               "graphed", "graphed_multi"))
    k3 = [s for s in profiling.recorded()[n0:] if s.name == "mbb.kernel.k3"]
    assert len(k3) == 3 * requests
    layouts = {(s.attrs["group"], s.attrs["cluster"]) for s in k3}
    ctx = types.SimpleNamespace(timeline=win.timeline, cfg=c.config,
                                traffic=c.traffic, requests=win.requests,
                                cards=[0])
    k3_s = win.timeline.kernel_s(0, readers.K3_KERNEL)
    roof = readers.roofline_pct(ctx, "catalog", readers.K3_KERNEL)
    gevals = bench.reader("k3_sed_gevals_per_s")(ctx)
    win.timeline = None
    curve = check.judge(win.kept, c.config, c.traffic, SEED, device="cuda")
    point_cfg = {k: v for k, v in c.config.items() if k != "responses"}
    tr_point = dict(c.traffic, check={k: v for k, v in c.traffic[
        "check"].items() if k != "posterior"})
    point = check.judge(win.kept, point_cfg, tr_point, SEED, device="cuda")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "requests": requests,
        "latency_ms": [r.latency_s * 1e3 for r in win.requests],
        "layouts": sorted(layouts),
        "k3_device_ms_per_request": k3_s / requests * 1e3,
        "request_bound_ms": readers.request_bound_ms(c.config, c.traffic,
                                                     256),
        "k3_roofline_pct": roof, "k3_sed_gevals_per_s": gevals,
        "curve": curve, "point_lnp_gap": point["lnp_gap"]}), flush=True)
    assert len(layouts) == 1
    assert sum(s.counters["sed_evals"] for s in k3) == \
        requests * 256 * 250 * 5 * 65 * (2 * 1500 + 8000)
    for k, v in c.limits.items():
        assert curve[k] < v, (k, curve)
    assert point["lnp_gap"] > c.limits["lnp_gap"]
