"""Filter-response configurations in the harness: the point path as it
was, bit for bit; the reference's quadrature of each curve against the
port's built-in curves; a response configuration driven through the
workload and judged against the curve reference, which it passes, and
against the point reference, which it fails. The `cuda` case drives
BASELINE config 3's shape on the card."""

import hashlib
import json
import types

import numpy as np
import pytest

from portbench import check, harness, mockdata, readers, yardstick
from portbench.bench import HERE, Cell
from portbench.reference.response import pack_of
from portbench.workload import Workload

SEED = 2 ** 31 + 4242


def _herschel(lo, hi):
    return {"edges": [lo, hi], "order": 4, "detector": "bolometer",
            "refspec_index": -1.0, "anchor": "effective"}


# The five PACS/SPIRE curves as mbb_emcee_tpu_torch/instruments.py's
# BUILTIN_BANDS approximates them: half-power edges from the PACS and SPIRE
# observers' manuals, order-4 super-Gaussian edges, bolometers quoting
# against nu S_nu = const at the effective wavelength.
RESPONSES = {
    "source": "mbb_emcee_tpu_torch/instruments.py BUILTIN_BANDS "
              "(approximating the PACS and SPIRE handbooks' band edges)",
    "nnodes": 65,
    "cutoff_exponent": 9.2,
    "bands": {"PACS_100": _herschel(85.0, 130.0),
              "PACS_160": _herschel(130.0, 210.0),
              "SPIRE_250": _herschel(212.0, 288.0),
              "SPIRE_350": _herschel(297.0, 403.0),
              "SPIRE_500": _herschel(400.0, 600.0)},
}


def config3(nwalkers=250):
    """BASELINE.json config 3 on mbb5_single's photometry: the optically
    thin three-parameter MBB (T, beta, fnorm), no priors, each band's flux
    the quadrature over its filter curve."""
    cfg = json.loads(json.dumps(Cell("single_converged").config))
    cfg.update(name="mbb3_response65", nwalkers=nwalkers, priors=[],
               responses=RESPONSES)
    cfg["model"] = dict(cfg["model"], opthin=True, noalpha=True)
    return cfg


def traffic(name, **change):
    with open(HERE / "traffic" / f"{name}.json") as fh:
        tr = json.load(fh)
    tr.update(change)
    return tr


# -- the point path, pinned -------------------------------------------------
# sha256 of flux, unc and z of request 0 as the harness drew them before
# configurations could hold filter responses, and the fit seed.
PINNED = {
    ("single_converged", 0): ("f1501e38ea716aef6a183abcd90349f3c02f87b11e3"
                              "1e7cee569b41ca02ea45f", 2797613725383355551),
    ("single_converged", 1): ("0a1e7bc424d19bd263a486749775ea0ee543b5847da"
                              "dac6a3fb9ee48b66ed342", 3817104479337814857),
    ("single_converged", 2): ("7d0e8137857d6822a21851d261e164a71cb2f0fc201"
                              "1e235ebefb655344b4939", 866540752892264132),
    ("catalog_converged", 0): ("6029b41f3404cf0a781d65a700b44ac17ead481b0d"
                               "94b2c3c2f68b28885f1758", 1026839505482957877),
    ("catalog_converged", 1): ("df7f9c9a10b0022585e9995f9e0ec8f13ccd969be8"
                               "81bdef431d320ba741fd1e", 3917085880722756190),
    ("catalog_converged", 2): ("79167fef84f4bb8de364fd8d47c79651254ccabb40"
                               "07bbadc666b48b39e5be35", 2938648721761368556),
}
PINNED_BOUND_MS = {"single_converged": 0.10235044029850746,
                   "catalog_cli_derived": 0.8400888358208956,
                   "catalog_converged": 26.20171271641791}


@pytest.mark.parametrize("cell,seed", sorted(PINNED))
def test_point_request_data_is_pinned(cell, seed):
    c = Cell(cell)
    flux, unc, z, fit_seed = mockdata.request_data(c.config, c.traffic,
                                                   seed, 0)
    h = hashlib.sha256()
    for a in (flux, unc, z):
        h.update(np.ascontiguousarray(a).tobytes())
    assert (h.hexdigest(), fit_seed) == PINNED[cell, seed]


@pytest.mark.parametrize("cell", sorted(PINNED_BOUND_MS))
def test_point_yardstick_is_pinned(cell):
    c = Cell(cell)
    assert readers._icfg(c.config) == (0, 0, 0, 5, 1)
    assert readers.request_bound_ms(
        c.config, c.traffic, int(c.config["nsources"])) == \
        PINNED_BOUND_MS[cell]


# -- the reference's curves against the port's --------------------------------
def test_reference_pack_matches_the_ports_builtin_curves():
    """The reference's nodes and weights from the configuration's numbers
    against the port's fp64 curves to 1e-12, and the port's fp32 pack is
    those rounded."""
    from mbb_emcee_tpu_torch.response import ResponseSet
    cfg = config3()
    bands = cfg["bands"]
    rs = ResponseSet.builtin(bands, nnodes=RESPONSES["nnodes"])
    waves, weights = pack_of(cfg)
    for i, name in enumerate(bands):
        np.testing.assert_allclose(waves[i], rs[name].wave, rtol=1e-12)
        np.testing.assert_allclose(weights[i], rs[name].weights,
                                   rtol=1e-12)
    w32, wt32 = rs.pack(bands)
    np.testing.assert_array_max_ulp(waves.astype(np.float32), w32, 1)
    np.testing.assert_array_max_ulp(weights.astype(np.float32), wt32, 1)


def test_true_flux_of_a_response_configuration():
    """The oracle's SED contracted with the reference's curves: per cent
    to tens of per cent from the SED at the bands' labels (0.9-21% here:
    the colour correction, and each curve's effective wavelength off its
    label)."""
    cfg = config3()
    point = mockdata.true_flux({k: v for k, v in cfg.items()
                                if k != "responses"})
    curve = mockdata.true_flux(cfg)
    assert curve.shape == point.shape == (5,)
    share = np.abs(curve / point - 1.0)
    assert 0.005 < share.min() and share.max() < 0.3


# -- the yardstick of a response configuration --------------------------------
@pytest.mark.parametrize("opthin,noalpha,want_us", [
    (True, True, 23.94),          # config 3's three-parameter model
    (False, False, 40.51),        # config 2's five-parameter model
])
def test_request_bound_counts_the_curves(opthin, noalpha, want_us):
    cfg = config3()
    cfg["model"] = dict(cfg["model"], opthin=opthin, noalpha=noalpha)
    nfree = 5 - int(opthin) - int(noalpha)
    tr = {"nburn": 0, "nsteps": 200, "thin": 1}
    got = readers.request_bound_ms(cfg, tr, 1)
    nconsts = 20 + 2 * 5 + 2 * 5 * 65
    want = yardstick.k2_bound((int(opthin), int(noalpha), 0, 5, 65), 1, 250,
                              nfree, nconsts, 200, 200)
    assert want[1] == "operations"
    assert got == want[0]
    assert got * 1e3 == pytest.approx(want_us, abs=0.005)


# -- a response configuration through the harness -----------------------------
def _window(cfg, tr, requests):
    """`requests` requests of the configuration on the CPU."""
    work = Workload(cfg, tr, device="cpu")
    return harness.measure(work, SEED, 0.0, max_requests=requests)


def _catalog(cfg):
    """The configuration as a catalog of four sources, one of them missing
    its first band."""
    return dict(cfg, fitter="catalog", nsources=4, missing_every=4,
                missing_band=0)


@pytest.mark.parametrize("fitter", ["single", "catalog"])
def test_response_fit_passes_the_curve_reference_and_fails_the_point_one(
        fitter):
    cfg = config3(nwalkers=32)
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


def test_posterior_holds_the_parameters_the_model_leaves_out():
    """Optically thin dust without the Wien power law: the density does not
    depend on lambda0 or alpha, which the fit holds fixed, so the reference
    posterior is over T, beta and fnorm alone (over all five it would be
    the flat box in two of them, which no fit samples). A fit long enough
    to reach the posterior then passes post_gap under the single cells'
    limit."""
    cfg = config3(nwalkers=64)
    tr = traffic("converged", nburn=500, nsteps=2000, thin=4)
    tr["check"]["posterior"] = {"rounds": 6, "round_samples": 1 << 15,
                                "samples": 1 << 16}
    win = _window(cfg, tr, 1)
    index, items = win.kept[0]
    it = items[0]
    mean, sigma = check._prior_arrays(cfg)
    pack = pack_of(cfg)

    def lnp_fn(t):
        return check.ref.lnprob(t, cfg["wave"], it["flux"], it["unc"],
                                cfg["lower"], cfg["upper"], mean, sigma,
                                check._shape(cfg), pack)
    post = check._posterior(cfg, tr, SEED, index, 0, lnp_fn, mean, sigma,
                            "cpu")
    assert sorted(post) == [0, 1, 4]
    numbers = check.judge(win.kept, cfg, tr, SEED)
    assert numbers["post_gap"] < Cell("single_converged").limits["post_gap"]


@pytest.mark.cuda
def test_response_config_on_the_card(card):
    """BASELINE config 3's shape at the converged depth on the card: 250
    walkers, the five curves at 65 nodes, K2 in response mode. Prints the
    readings as one JSON line (run with -s)."""
    import torch
    cfg = config3()
    tr = traffic("converged")
    work = Workload(cfg, tr, device="cuda")
    work.run(SEED, -1, harness.Spans(False, False))
    torch.cuda.synchronize()
    requests = 4
    win = harness.measure(work, SEED, 1e9, trace=True,
                          max_requests=requests)
    launches = {k: sum(r.launches[k] for r in win.requests)
                for k in win.requests[0].launches}
    assert not [r.error for r in win.requests if r.error]
    assert launches["k2"] >= requests
    assert not any(r.launches[k] for r in win.requests
                   for k in ("plain", "plain_multi", "graphed",
                             "graphed_multi"))
    ctx = types.SimpleNamespace(timeline=win.timeline, cfg=cfg, traffic=tr,
                                requests=win.requests, cards=[0])
    k2_s = win.timeline.kernel_s(0, readers.K2_KERNEL)
    roof = readers.roofline_pct(ctx, "single", readers.K2_KERNEL)
    win.timeline = None
    curve = check.judge(win.kept, cfg, tr, SEED, device="cuda")
    point_cfg = {k: v for k, v in cfg.items() if k != "responses"}
    tr_point = dict(tr, check={k: v for k, v in tr["check"].items()
                               if k != "posterior"})
    point = check.judge(win.kept, point_cfg, tr_point, SEED, device="cuda")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "requests": requests,
        "latency_ms": [r.latency_s * 1e3 for r in win.requests],
        "k2_launches": launches["k2"], "k1_launches": launches["k1"],
        "k2_device_ms_per_request": k2_s / requests * 1e3,
        "request_bound_ms": readers.request_bound_ms(cfg, tr, 1),
        "k2_roofline_pct": roof, "curve": curve,
        "point_lnp_gap": point["lnp_gap"]}), flush=True)
    assert curve["lnp_gap"] < 1e-3 < point["lnp_gap"]
