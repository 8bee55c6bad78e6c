"""The lnprob kernel's layout planner and the host side of a call:
plan_lnprob_launch's layouts fit the kernel's limits and follow its table
(lanes per vector only while the batch's lanes stay within the budget per
SM), a bad plan is refused before anything runs, a plan leaves the CPU
result unchanged, and MBBFitter.__call__'s cached operands see every change
the fitter's setters can make, against the JAX package's __call__."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import response as jresponse  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    LikelihoodSpec, Photometry)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape)
from mbb_emcee_tpu_torch.ops import build, sampler_kernel  # noqa: E402
from mbb_emcee_tpu_torch.ops.lnprob_kernel import (  # noqa: E402
    H100_SMEM_OPTIN, H100_SMS, LNPROB_BLOCK_THREADS, LNPROB_GROUPS,
    LNPROB_MAX_THREADS, LNPROB_MIN_THREADS, LNPROB_PLAN_TABLE,
    LNPROB_SM_LANES, LnprobPlan, check_lnprob_plan, fit_threads, lnprob_plan,
    lnprob_tiles, mbb_lnprob, plan_lnprob_launch, plan_mode, plan_smem_bytes,
    prepare_lnprob_inputs)
from mbb_emcee_tpu_torch.response import ResponseSet  # noqa: E402

PACKS = [(5, 1), (5, 65), (5, 129), (8, 1000)]
SIZES = [1, 250, 4096, 62500, 1048576]
# (noalpha, opthin): the merge solve, no merge solve thick, and thin
MODELS = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("nb,nnodes", PACKS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("noalpha,opthin", MODELS)
def test_plan_lnprob_launch_fits_the_kernel(nb, nnodes, n, noalpha, opthin):
    plan = plan_lnprob_launch(nb, nnodes, n, noalpha, opthin)
    check_lnprob_plan(plan, nb, nnodes, n)
    assert plan.group in LNPROB_GROUPS and 32 % plan.group == 0
    assert plan.threads % 32 == 0
    assert LNPROB_MIN_THREADS <= plan.threads <= LNPROB_MAX_THREADS
    # every vector has a tile, every tile a block of its own
    vectors = plan.threads // plan.group
    assert plan.blocks == lnprob_tiles(n, plan.group, plan.threads)
    assert (plan.blocks - 1) * vectors < n <= plan.blocks * vectors
    assert plan.smem_bytes == plan_smem_bytes(nb, nnodes, plan.threads)
    assert plan.smem_bytes <= H100_SMEM_OPTIN
    # the first of the mode's lanes per vector within the budget per SM
    table = LNPROB_PLAN_TABLE[plan_mode(nnodes, noalpha, opthin)]
    fits = [g for g in table
            if g == 1 or n * g <= H100_SMS * LNPROB_SM_LANES]
    assert plan.group == fits[0]


def test_plan_smem_bytes_is_the_kernels_layout():
    """csrc/lnprob.cuh's mbb_lik_dyn_bytes, written out: the packed
    constants (20 + nb (nb + 2) + 2 nb nnodes floats), then one slot per
    band per thread."""
    assert plan_smem_bytes(5, 1, 128) == 4 * (20 + 35 + 10 + 5 * 128) == 2820
    assert plan_smem_bytes(5, 65, 128) == 5380
    assert plan_smem_bytes(8, 1000, 32) == 4 * (20 + 80 + 16000 + 256)


def test_plan_modes_follow_the_table():
    """A fit's 250 vectors take lanes per vector in every mode (8 in point
    mode, where the sweep found 4 lanes never the fastest; 32 on a response
    pack); a batch that fills the card takes one thread per vector in every
    mode."""
    for noalpha, opthin in MODELS:
        assert plan_lnprob_launch(5, 1, 250, noalpha, opthin).group == 8
        assert plan_lnprob_launch(5, 1, 16384, noalpha, opthin).group == 1
    assert plan_lnprob_launch(5, 65, 250, True, True).group == 32
    assert [plan_lnprob_launch(5, 65, n, True, True).group
            for n in (4096, 16384, 62500)] == [16, 4, 1]
    for nnodes, noalpha, opthin in ((1, False, False), (1, True, False),
                                    (1, True, True), (65, True, True)):
        plan = plan_lnprob_launch(5, nnodes, 1048576, noalpha, opthin)
        assert (plan.group, plan.threads) == (1, LNPROB_BLOCK_THREADS)
        assert plan.blocks == 1048576 // LNPROB_BLOCK_THREADS
    assert sampler_kernel.plan_mode is plan_mode


@pytest.mark.parametrize("sm_count,nnodes,group", [
    (132, 1, 8), (4, 1, 8), (3, 1, 1), (1, 1, 1),
    (132, 65, 32), (15, 65, 16), (4, 65, 8), (2, 65, 4), (1, 65, 1)])
def test_lanes_stay_within_the_budget_per_sm(sm_count, nnodes, group):
    """250 vectors on a stand-in card of `sm_count` SMs: n x G lanes at
    most sm_count x LNPROB_SM_LANES, else fewer lanes, then one."""
    plan = plan_lnprob_launch(5, nnodes, 250, sm_count=sm_count)
    assert plan.group == group
    assert group == 1 or 250 * group <= sm_count * LNPROB_SM_LANES
    table = LNPROB_PLAN_TABLE[plan_mode(nnodes)]
    for g in table[:table.index(group)]:
        assert 250 * g > sm_count * LNPROB_SM_LANES


@pytest.mark.parametrize("limit,threads", [
    (H100_SMEM_OPTIN, 128), (68000, 96), (66000, 32), (60000, 32)])
def test_block_shrinks_to_the_cards_shared_memory(limit, threads):
    """The 8 x 1000 pack's constants alone are 64,400 bytes: the block
    loses a warp at a time while it does not fit, down to one warp; a
    plan that still does not fit is returned as it is (the launch refuses
    it by the card's limit)."""
    assert fit_threads(8, 1000, limit) == threads
    plan = plan_lnprob_launch(8, 1000, 250, True, True, smem_limit=limit)
    assert plan.threads == threads
    assert plan.smem_bytes == plan_smem_bytes(8, 1000, threads)
    assert (plan.smem_bytes <= limit) == (limit > 60000)
    check_lnprob_plan(plan, 8, 1000, 250)


WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([8.62, 23.3, 41.2, 44.6, 45.0])
NAMES = ["PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350", "SPIRE_500"]
TRUE = np.array([35.0, 1.8, 200.0, 3.0, 45.0])


def _ops():
    spec = LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = 100.0, 5.0
    return prepare_lnprob_inputs(Photometry(WAVE, FLUX, 0.05 * FLUX),
                                 MBBShape(), spec, device="cpu")


def _thetas(n=40, seed=3):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((TRUE[None] * rng.uniform(
        0.7, 1.3, (n, 5))).astype(np.float32))


GOOD = lnprob_plan(8, 64, 40, 5, 1)


@pytest.mark.parametrize("bad,match", [
    (dataclasses.replace(GOOD, group=2), "group 2"),
    (dataclasses.replace(GOOD, threads=48,
                         smem_bytes=plan_smem_bytes(5, 1, 48)),
     "multiple of 32"),
    (dataclasses.replace(GOOD, threads=512,
                         smem_bytes=plan_smem_bytes(5, 1, 512)), "256"),
    (dataclasses.replace(GOOD, blocks=0), "0 blocks outside 1..5"),
    (dataclasses.replace(GOOD, blocks=6), "6 blocks outside 1..5"),
    (dataclasses.replace(GOOD, smem_bytes=GOOD.smem_bytes + 4),
     "smem_bytes"),
    ((8, 64), "LnprobPlan")])
def test_bad_plan_is_refused_on_a_cpu_tensor(bad, match):
    with pytest.raises(ValueError, match=match):
        mbb_lnprob(_thetas(), _ops(), plan=bad)


def test_a_plan_leaves_the_cpu_result_unchanged():
    """On the CPU the plain version runs whatever the (valid) plan, a
    looping one (fewer blocks than tiles) included, and no launch is
    counted."""
    ops, x = _ops(), _thetas()
    launches = mbb_lnprob.launches
    want = mbb_lnprob(x, ops)
    assert torch.equal(want, ops.plain(x))
    for plan in (GOOD, dataclasses.replace(GOOD, blocks=2),
                 lnprob_plan(1, 128, 40, 5, 1), lnprob_plan(32, 256, 40, 5, 1)):
        assert isinstance(plan, LnprobPlan)
        assert torch.equal(mbb_lnprob(x, ops, plan=plan), want)
    assert mbb_lnprob.launches == launches


def test_ptxas_report_reads_the_lnprob_kernels_lanes():
    log = """\
ptxas info    : Compiling entry function '_Z17mbb_lnprob_kernelILi8EEvPKfS1_Pfii9MbbConfig' for 'sm_90a'
ptxas info    : Function properties for _Z17mbb_lnprob_kernelILi8EEvPKfS1_Pfii9MbbConfig
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 57 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z22mbb_lnprob_loop_kernelILi32EEvPKfS1_Pfii9MbbConfig' for 'sm_90a'
ptxas info    : Function properties for _Z22mbb_lnprob_loop_kernelILi32EEvPKfS1_Pfii9MbbConfig
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z18mbb_stretch_kernelILi16ELb1EEvPKfPKiS1_S1_PfS4_S4_S4_Piiiiifyy9MbbConfig' for 'sm_90a'
ptxas info    : Function properties for _Z18mbb_stretch_kernelILi16ELb1EEvPKfPKiS1_S1_PfS4_S4_S4_Piiiiifyy9MbbConfig
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 121 registers, used 1 barriers
"""
    assert build.ptxas_report(log) == [
        {"kernel": "mbb_lnprob_kernel", "group": 8, "cluster": None,
         "registers": 57, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "mbb_lnprob_loop_kernel", "group": 32, "cluster": None,
         "registers": 48, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "mbb_stretch_kernel", "group": 16, "cluster": True,
         "registers": 121, "spill_stores": 0, "spill_loads": 0}]


# -- MBBFitter.__call__ and its cached operands ------------------------------

def _fits(responses=False, **kw):
    """Port (CPU) and JAX MBBFitter on the same data, box and prior."""
    fits = []
    for pkg, rset in ((T, ResponseSet), (J, jresponse.ResponseSet)):
        extra = dict(kw)
        if responses:
            extra["responses"] = rset.builtin(NAMES, nnodes=17)
        if pkg is T:
            extra["device"] = "cpu"
        fit = pkg.MBBFitter(nwalkers=16, **extra)
        fit.set_data(WAVE, FLUX, 0.05 * FLUX,
                     band_names=NAMES if responses else None)
        fit.set_uplim("T", 100.0).set_uplim("beta", 5.0)
        fit.set_gaussian_prior("beta", 1.8, 0.3)
        fits.append(fit)
    return fits


def _vectors(seed):
    return TRUE[None] * np.random.default_rng(seed).uniform(0.8, 1.2, (8, 5))


def _agree(tfit, jfit, seed=5):
    got = np.array([tfit(th) for th in _vectors(seed)])
    want = np.array([jfit(th) for th in _vectors(seed)])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    return got


@pytest.mark.parametrize("responses", [False, True],
                         ids=["point", "response"])
def test_fitter_call_matches_jax(responses):
    tfit, jfit = _fits(responses)
    first = _agree(tfit, jfit)
    ops = tfit._call_cache[1]
    # a second pass reuses the packed operands and gives the same values
    assert np.array_equal(_agree(tfit, jfit), first)
    assert tfit._call_cache[1] is ops


def _set_data(fit):
    fit.set_data(WAVE, 1.1 * FLUX, 0.04 * FLUX)


def _set_cov(fit):
    unc = 0.05 * FLUX
    cov = np.diag(unc ** 2) + 0.3 * np.outer(unc, unc)
    fit.set_data(WAVE, FLUX, unc, cov=cov)


def _edit_flux_in_place(fit):
    phot = fit.phot if hasattr(fit, "phot") else fit._require_data()
    phot.flux[2] *= 1.05


@pytest.mark.parametrize("change", [
    _set_data, _set_cov, _edit_flux_in_place,
    lambda f: f.set_uplim("T", 36.0),
    lambda f: f.set_lowlim("beta", 1.9),
    lambda f: f.set_gaussian_prior("beta", 2.2, 0.1),
    lambda f: f.set_gaussian_prior("T", 30.0, 2.0),
    lambda f: f.set_phot_upperlimits([False, False, False, False, True])],
    ids=["set_data", "covariance", "flux edited in place", "upper bound",
         "lower bound", "prior moved", "prior added", "upper-limit band"])
def test_fitter_call_sees_a_change(change):
    """After the change the cached operands are rebuilt: the values move
    as the JAX package's do (some vectors now fall outside the box)."""
    tfit, jfit = _fits()
    before = _agree(tfit, jfit)
    ops = tfit._call_cache[1]
    change(tfit)
    change(jfit)
    after = _agree(tfit, jfit)
    assert tfit._call_cache[1] is not ops
    assert not np.array_equal(before, after)


def test_fitter_call_sees_a_new_response_set():
    tfit, jfit = _fits(responses=True)
    before = _agree(tfit, jfit)
    ops = tfit._call_cache[1]
    tfit.responses = ResponseSet.builtin(NAMES, nnodes=33)
    jfit.responses = jresponse.ResponseSet.builtin(NAMES, nnodes=33)
    after = _agree(tfit, jfit)
    assert tfit._call_cache[1] is not ops
    assert int(tfit._call_cache[1].icfg[4]) == 33
    assert not np.array_equal(before, after)
    # one band's filter replaced inside the same set
    ops = tfit._call_cache[1]
    tfit.responses.add("SPIRE_500", "box:500:150")
    jfit.responses.add("SPIRE_500", "box:500:150")
    moved = _agree(tfit, jfit)
    assert tfit._call_cache[1] is not ops
    assert not np.array_equal(after, moved)
    # and point mode again
    tfit.responses = jfit.responses = None
    _agree(tfit, jfit)
    assert int(tfit._call_cache[1].icfg[4]) == 1
