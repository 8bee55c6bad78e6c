"""The stretch-move kernel's layout planner and the tree form of its merge
solve: plan_stretch_launch's layouts fit the kernel's limits, a bad plan
is refused before anything runs, and the merge solve taken as 2 rounds of
a 7-node tree (how the kernels' lanes run it from 8 lanes per walker),
as 3 rounds of a 3-node tree (4 lanes) and as 6 single steps (2 lanes) is
the sequential bisection bit for bit and agrees with the JAX package's
solve."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    merge_log_x as j_merge_log_x)
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    LikelihoodSpec, Photometry)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MERGE_NEWTON, MBBShape, _merge_g_and_gp, merge_bracket, merge_log_x)
from mbb_emcee_tpu_torch.ops.rootfind import (  # noqa: E402
    bisect_newton_decreasing, bisect_tree_newton_decreasing)
from mbb_emcee_tpu_torch.ops.sampler_kernel import (  # noqa: E402
    GROUPS, H100_SMEM_OPTIN, MAX_CLUSTER, MAX_THREADS, FusedSampler,
    StretchPlan, max_threads, mbb_stretch_run, plan_stretch_launch,
    run_smem_bytes, stretch_plan)
from mbb_emcee_tpu_torch.sampler import make_initial_ball  # noqa: E402

N_MERGE = 12000


def _merge_inputs(seed):
    """(beta, ln x0, alpha) over and beyond the region the walkers explore:
    beta 0.1-4, ln x0 for lambda0 x T from 50 um x 100 K to 1000 um x 5 K
    and past it, alpha 0.5-8."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 4.0, N_MERGE).astype(np.float32),
            rng.uniform(-3.0, 5.0, N_MERGE).astype(np.float32),
            rng.uniform(0.5, 8.0, N_MERGE).astype(np.float32))


def _tree_merge_log_x(beta, log_x0, alpha, opthin, rounds=2, levels=3,
                      newton_iters=MERGE_NEWTON):
    """merge_log_x with its 6 bisections as `rounds` rounds of a tree of
    `levels` levels (the stretch-move kernel's: 2 x 3)."""
    return bisect_tree_newton_decreasing(
        lambda u: _merge_g_and_gp(u, beta, log_x0, alpha, opthin),
        *merge_bracket(beta, alpha), rounds=rounds, levels=levels,
        newton_iters=newton_iters)


# Tree shapes (rounds, levels): the kernels' 2 x 3 (K2's and K3's cluster
# layouts, 8-32 lanes per walker) and 3 x 2 (K3's 4 lanes), and 6 x 1, the
# sequential bisection itself; the 2 x 3 cases keep their first ids.
TREE_SHAPES = pytest.mark.parametrize("opthin,rounds,levels", [
    (True, 2, 3), (False, 2, 3), (True, 3, 2), (False, 3, 2), (True, 6, 1),
    (False, 6, 1)], ids=["thin", "thick", "thin-3x2", "thick-3x2",
                         "thin-6x1", "thick-6x1"])


@TREE_SHAPES
def test_tree_merge_solve_is_the_sequential_one_bitwise(opthin, rounds,
                                                        levels):
    beta, log_x0, alpha = (torch.as_tensor(v) for v in _merge_inputs(
        1 + opthin))
    seq = merge_log_x(beta, log_x0, alpha, opthin)
    tree = _tree_merge_log_x(beta, log_x0, alpha, opthin, rounds, levels)
    assert seq.dtype == torch.float32
    assert torch.equal(seq, tree)


@pytest.mark.parametrize("rounds,levels", [(1, 6), (2, 3), (3, 2), (6, 1)])
def test_tree_bisection_any_shape_is_the_sequential_one(rounds, levels):
    """6 bisections in any rounds x levels split give the same bracket;
    the bracket alone (no Newton step) pins the walk."""
    beta, log_x0, alpha = (torch.as_tensor(v) for v in _merge_inputs(7))
    want = bisect_newton_decreasing(
        lambda u: _merge_g_and_gp(u, beta, log_x0, alpha, False),
        *merge_bracket(beta, alpha), bisect_iters=6, newton_iters=0)
    got = _tree_merge_log_x(beta, log_x0, alpha, False, rounds, levels, 0)
    assert torch.equal(want, got)


@TREE_SHAPES
def test_tree_merge_solve_matches_jax(opthin, rounds, levels):
    """Against mbb_emcee_tpu's merge_log_x on the same fp32 inputs, within
    tests/test_torch_model.py's atol on log quantities (5e-5), for each
    tree shape the kernels run."""
    beta, log_x0, alpha = _merge_inputs(11 + opthin)
    want = np.asarray(jax.jit(lambda b, x, a: j_merge_log_x(
        b, x, a, opthin))(jnp.asarray(beta), jnp.asarray(log_x0),
                          jnp.asarray(alpha)))
    got = _tree_merge_log_x(
        *(torch.as_tensor(v) for v in (beta, log_x0, alpha)), opthin, rounds,
        levels).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("nb,nnodes,half", [
    (5, 1, 125), (5, 65, 125), (5, 129, 125), (8, 1000, 125), (5, 1, 1024)])
def test_plan_stretch_launch_fits_the_kernel(nb, nnodes, half):
    plan = plan_stretch_launch(nb, nnodes, half)
    assert plan.group in GROUPS
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    assert plan.threads <= max_threads(plan.group)
    # every walker is owned, and a walker's lanes lie in one warp
    assert plan.walkers_per_block * plan.cluster >= half
    assert plan.walkers_per_block * plan.group <= plan.threads
    assert 32 % plan.group == 0
    assert plan.smem_bytes == run_smem_bytes(nb, nnodes, half, plan.threads)
    assert plan.smem_bytes <= H100_SMEM_OPTIN
    if half == 1024:
        assert (plan.group, plan.cluster) == (1, 1)
        assert plan.walkers_per_block == plan.threads == 1024
    else:
        assert plan.group > 1 and plan.cluster > 1


def test_run_smem_bytes_is_the_kernels_layout():
    """csrc/stretch.cuh's mbb_run_dyn_bytes, written out: the packed
    constants (20 + nb (nb + 2) + 2 nb nnodes floats), one slot per band per
    thread, then positions, lnprob and accepts at half rounded up to 32."""
    assert run_smem_bytes(5, 1, 125, 128) == 4 * (20 + 35 + 10 + 5 * 128) \
        + 128 * (12 * 4 + 2 * 4)
    # the one-block layout at config 2 and at config 3's 5 x 65 pack
    assert run_smem_bytes(5, 1, 125, 128) == 9988
    assert run_smem_bytes(5, 65, 125, 128) == 12548


@pytest.mark.parametrize("opthin,grouped", [(False, True), (True, False)],
                         ids=["thick", "thin"])
def test_plan_without_the_merge_solve_follows_the_sweep(opthin, grouped):
    """Point mode with alpha fixed has no merge solve to split: the sweep
    measured lanes per walker a gain for the thick model and a loss for
    the optically thin one, whose lnprob is shortest (PERF.md)."""
    plan = plan_stretch_launch(5, 1, 125, noalpha=True, opthin=opthin)
    assert (plan.group > 1) == grouped
    if not grouped:
        assert plan == stretch_plan(1, 1, 5, 1, 125)
    # response mode splits the band nodes whatever the model
    assert plan_stretch_launch(5, 65, 125, noalpha=True,
                               opthin=opthin).group > 1


@pytest.mark.parametrize("half,group", [(125, 32), (250, 16), (512, 8),
                                        (600, 1)])
def test_plan_halves_the_lanes_for_larger_ensembles(half, group):
    """Response mode on the table's 8-block cluster: fewer lanes per walker
    as the ensemble grows, one thread per walker when 8 lanes do not fit."""
    plan = plan_stretch_launch(5, 65, half)
    assert plan.group == group
    assert plan.cluster == (8 if group > 1 else 1)
    assert plan.threads <= max_threads(group)


def test_plan_falls_back_when_the_card_is_small():
    plan = plan_stretch_launch(8, 1000, 125, smem_limit=60000)
    assert (plan.group, plan.cluster) == (1, 1)
    assert plan == stretch_plan(1, 1, 8, 1000, 125)


WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([8.62, 23.3, 41.2, 44.6, 45.0])


def _sampler():
    spec = LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = 100.0, 5.0
    return FusedSampler(16, Photometry(WAVE, FLUX, 0.05 * FLUX), MBBShape(),
                        spec, device="cpu")


def _state(samp):
    p0 = make_initial_ball(torch.Generator().manual_seed(1),
                           [30.0, 1.8, 250.0, 3.5, 40.0],
                           [2.0, 0.1, 20.0, 0.3, 1.0], 16,
                           samp.free_space.lower, samp.free_space.upper,
                           device="cpu")
    return samp.init_state(p0, seed=5)


GOOD = stretch_plan(8, 4, 5, 1, 8)


@pytest.mark.parametrize("bad,match", [
    (dataclasses.replace(GOOD, group=4), "group 4"),
    (dataclasses.replace(GOOD, cluster=16), "cluster 16"),
    (dataclasses.replace(GOOD, walkers_per_block=1), "do not hold"),
    (dataclasses.replace(GOOD, threads=48), "multiple of 32"),
    (dataclasses.replace(GOOD, threads=1024,
                         smem_bytes=run_smem_bytes(5, 1, 8, 1024)),
     "512"),
    (dataclasses.replace(GOOD, smem_bytes=GOOD.smem_bytes - 4),
     "smem_bytes"),
    (dataclasses.replace(stretch_plan(1, 1, 5, 1, 8), threads=64,
                         smem_bytes=run_smem_bytes(5, 1, 8, 64)),
     "one block of one thread per walker runs 32 threads"),
    ((8, 4), "StretchPlan")])
def test_bad_plan_is_refused_on_a_cpu_state(bad, match):
    samp = _sampler()
    state = _state(samp)
    with pytest.raises(ValueError, match=match):
        mbb_stretch_run(state, samp.ops, 2, 1, plan=bad)


def test_a_plan_leaves_the_cpu_run_unchanged():
    """On the CPU the plain version runs whatever the (valid) plan."""
    samp = _sampler()
    state = _state(samp)
    want = mbb_stretch_run(state, samp.ops, 3, 2)
    for plan in (GOOD, stretch_plan(1, 1, 5, 1, 8)):
        assert isinstance(plan, StretchPlan)
        got = mbb_stretch_run(state, samp.ops, 3, 2, plan=plan)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
