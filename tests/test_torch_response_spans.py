"""The program's spans and counter for response mode
(mbb_emcee_tpu_torch/utils/profiling.py) on the CPU: each kernel wrapper's
span records its bands and nodes a band (a response pack's padded count,
1 for point bands) and counts `sed_evals`, the SED evaluations of its
launch (K1 vectors x bands x nodes, K2 steps x walkers x bands x nodes, K3
that x sources), on the kernels' plain versions as on the card; K3's
records the group and cluster of the layout it launched on the card
alone (`-m cuda`, with --noconftest: this file imports no jax); the
response pack's own span opens in response mode only; without a profiler
nothing is recorded."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu_torch import MBBFitter, MBBResults, MultiFitter  # noqa
from mbb_emcee_tpu_torch.ops.lnprob_kernel import (  # noqa: E402
    mbb_lnprob, prepare_lnprob_inputs)
from mbb_emcee_tpu_torch.response import ResponseSet  # noqa: E402
from mbb_emcee_tpu_torch.utils import profiling  # noqa: E402

BANDS = ["PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350", "SPIRE_500"]
WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([11.2, 32.1, 44.8, 38.2, 22.9])
NODES = {"point": 1, "response": 65}
NW, NBURN, NSTEPS = 16, 3, 4


def _recording(fn):
    """fn() under torch's CPU profiler; returns (fn's value, the spans it
    recorded)."""
    n0 = len(profiling.recorded())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.recorded()[n0:]


def _responses(mode):
    return (ResponseSet.builtin(BANDS, nnodes=NODES[mode])
            if mode == "response" else None)


def _single(mode):
    """A fused-backend thin three-parameter fit (the kernels' plain
    versions on the CPU) and its results."""
    fit = MBBFitter(nwalkers=NW, seed=3, opthin=True, noalpha=True,
                    device="cpu", sampler_backend="fused",
                    responses=_responses(mode))
    fit.set_data(WAVE, FLUX, 0.06 * FLUX,
                 band_names=BANDS if mode == "response" else None)
    fit.run(nburn=NBURN, nsteps=NSTEPS)
    return MBBResults(fit, redshift=2.0)


# the thin three-parameter model and the full five-parameter one (thick
# dust, free lambda0, the Wien power law merged at alpha)
MODELS = {"thin": dict(opthin=True, noalpha=True),
          "full": dict(opthin=False, noalpha=False)}


def _catalog(mode, nsrc=3, device="cpu", model="thin"):
    mf = MultiFitter(nwalkers=NW, seed=5, device=device,
                     sampler_backend="fused", responses=_responses(mode),
                     **MODELS[model])
    mf.set_data(WAVE, np.stack([FLUX * (1 + 0.2 * s) for s in range(nsrc)]),
                0.06 * np.stack([FLUX] * nsrc),
                band_names=BANDS if mode == "response" else None)
    mf.run(nburn=NBURN, nsteps=NSTEPS)
    return mf


def _named(spans, name):
    return [s for s in spans if s.name == name]


@pytest.mark.parametrize("mode", ["response", "point"])
def test_k2_counts_steps_walkers_bands_nodes(mode):
    _, spans = _recording(lambda: _single(mode))
    k2 = _named(spans, "mbb.kernel.k2")
    # the burn, the re-burn and production
    assert [s.attrs["steps"] for s in k2] == [NBURN, NBURN, NSTEPS]
    for s in k2:
        assert (s.attrs["bands"], s.attrs["nodes"]) == (5, NODES[mode])
        assert s.counters["sed_evals"] == \
            s.attrs["steps"] * NW * 5 * NODES[mode]
    assert sum(s.counters["sed_evals"] for s in k2) == \
        (2 * NBURN + NSTEPS) * NW * 5 * NODES[mode]


@pytest.mark.parametrize("mode", ["response", "point"])
@pytest.mark.parametrize("n", [NW, 7])
def test_k1_counts_vectors_bands_nodes(mode, n):
    """The fit's two K1 calls (the walker ball and the re-centred ball, a
    vector a walker each) and a direct call on n vectors."""
    if n == NW:
        _, spans = _recording(lambda: _single(mode))
        assert len(_named(spans, "mbb.kernel.k1")) == 2
    else:
        fit = MBBFitter(nwalkers=NW, opthin=True, noalpha=True,
                        device="cpu", responses=_responses(mode))
        fit.set_data(WAVE, FLUX, 0.06 * FLUX,
                     band_names=BANDS if mode == "response" else None)
        ops = prepare_lnprob_inputs(fit.phot, fit.shape,
                                    fit._effective_spec(),
                                    response_pack=fit._response_pack(),
                                    device="cpu")
        theta = torch.tensor([[30.0, 1.8, 40.0]] * n)   # T, beta, fnorm
        _, spans = _recording(lambda: mbb_lnprob(theta, ops))
    k1 = _named(spans, "mbb.kernel.k1")
    assert k1
    for s in k1:
        assert s.attrs == {"bands": 5, "nodes": NODES[mode]}
        assert s.counters["sed_evals"] == n * 5 * NODES[mode]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["response", "point"])
@pytest.mark.parametrize("nsrc", [1, 3])
def test_k3_counts_the_sources_too(mode, nsrc, model):
    """The CPU runs K3's plain version, which has no layout to record."""
    _, spans = _recording(lambda: _catalog(mode, nsrc, model=model))
    k3 = _named(spans, "mbb.kernel.k3")
    assert len(k3) == 3
    for s in k3:
        assert s.attrs == {"steps": s.attrs["steps"], "records":
                           s.attrs["records"], "sources": nsrc, "bands": 5,
                           "nodes": NODES[mode]}
        assert s.counters["sed_evals"] == \
            s.attrs["steps"] * NW * 5 * NODES[mode] * nsrc


@pytest.mark.parametrize("which", ["single", "catalog"])
@pytest.mark.parametrize("mode", ["response", "point"])
def test_response_pack_span_in_response_mode_only(which, mode):
    """Each pack is built under the pack's span, in response mode only: a
    single fit twice a request (MBBFitter.build under mbb.fit.run, then
    MBBResults' load), a catalog twice in its run (MultiFitter's sampler
    build and BatchEngine's posterior token)."""
    run = _single if which == "single" else _catalog
    _, spans = _recording(lambda: run(mode))
    packs = _named(spans, "mbb.fit.response_pack")
    if mode == "point":
        assert packs == []
        return
    assert packs
    for s in packs:
        assert s.attrs == {"bands": 5, "nodes": 65}
        assert s.start_ns <= s.end_ns
    parents = [spans[s.parent - spans[0].root].name for s in packs]
    assert parents == {"single": ["mbb.fit.run", "mbb.results.load"],
                       "catalog": ["mbb.fit.run", "mbb.fit.run"]}[which]


@pytest.mark.parametrize("which", ["single", "catalog", "pack"])
def test_nothing_is_recorded_without_a_profiler(which):
    n0 = len(profiling.recorded())
    if which == "single":
        _single("response")
    elif which == "catalog":
        _catalog("response")
    else:
        ResponseSet.builtin(BANDS, nnodes=65).pack(BANDS)
    assert not torch.autograd._profiler_enabled()
    assert len(profiling.recorded()) == n0


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["response", "point"])
@pytest.mark.parametrize("nsrc", [3, 256])
def test_k3_records_the_layout_it_launched_on_the_card(nsrc, mode, model):
    """Each K3 launch records the group and cluster of the plan it ran:
    plan_multi_on_card's for the catalog's shape and model."""
    from mbb_emcee_tpu_torch.ops.multifit_kernel import plan_multi_on_card
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, spans = _recording(lambda: _catalog(mode, nsrc, "cuda", model))
    plan = plan_multi_on_card(5, NODES[mode], NW // 2, nsrc,
                              MODELS[model]["noalpha"],
                              MODELS[model]["opthin"], 0)
    k3 = _named(spans, "mbb.kernel.k3")
    assert len(k3) == 3
    for s in k3:
        assert (s.attrs["group"], s.attrs["cluster"]) == \
            (plan.group, plan.cluster)
        assert s.counters["sed_evals"] == \
            s.attrs["steps"] * NW * 5 * NODES[mode] * nsrc
