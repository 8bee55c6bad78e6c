"""The multi-source stretch-move kernel's (K3's) launch planner:
plan_multi_launch's layouts fit the kernel's limits, keep a 256-source
catalog one wave on an H100's 132 SMs, take a cluster per source only where
the catalog leaves the SMs for it, fall back when shared memory is short,
and a bad plan is refused before anything runs, on a CPU state too; on the
CPU a valid plan leaves the plain multi run unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu_torch.likelihood import LikelihoodSpec  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape)
from mbb_emcee_tpu_torch.ops.build import ptxas_report  # noqa: E402
from mbb_emcee_tpu_torch.ops.multifit_kernel import (  # noqa: E402
    H100_SMS, MULTI_CLUSTER_GROUPS, MULTI_GROUPS, MULTI_LAYOUTS,
    MULTI_PLAN_TABLE, FusedMultiSampler, h100_resident,
    mbb_multi_stretch_run, plan_multi_launch)
from mbb_emcee_tpu_torch.ops.sampler_kernel import (  # noqa: E402
    H100_SMEM_OPTIN, MAX_CLUSTER, StretchPlan, check_plan, plan_mode,
    run_smem_bytes, stretch_plan)
from mbb_emcee_tpu_torch.sampler import make_initial_ball  # noqa: E402

MODES = [dict(), dict(noalpha=True), dict(noalpha=True, opthin=True)]
MODE_IDS = ["point", "noalpha-thick", "noalpha-thin"]


def _fits_the_kernel(plan, nb, nnodes, half):
    assert (plan.group, plan.cluster > 1) in MULTI_LAYOUTS
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.threads % 32 == 0
    assert plan.threads <= MULTI_LAYOUTS[(plan.group, plan.cluster > 1)]
    # every walker is owned, and a walker's lanes lie in one warp
    assert plan.walkers_per_block * plan.cluster >= half
    assert plan.walkers_per_block * plan.group <= plan.threads
    assert 32 % plan.group == 0
    assert plan.smem_bytes == run_smem_bytes(nb, nnodes, half, plan.threads)
    assert plan.smem_bytes <= H100_SMEM_OPTIN
    check_plan(plan, nb, nnodes, half, MULTI_LAYOUTS)


@pytest.mark.parametrize("nb,nnodes,half,nsrc", [
    (5, 1, 125, 1), (5, 1, 125, 4), (5, 1, 125, 256), (5, 1, 125, 1024),
    (5, 65, 125, 4), (5, 65, 125, 256), (5, 129, 125, 256),
    (8, 1000, 125, 256), (5, 1, 512, 256), (5, 65, 1024, 4)])
def test_plan_multi_launch_fits_the_kernel(nb, nnodes, half, nsrc):
    for kw in MODES:
        _fits_the_kernel(plan_multi_launch(nb, nnodes, half, nsrc, **kw),
                         nb, nnodes, half)


@pytest.mark.parametrize("nnodes", [1, 65, 129])
@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_a_256_source_catalog_stays_one_wave(nnodes, kw):
    """256 sources of 250 walkers on 132 SMs: two blocks per SM. Never G = 8
    in one block (1,000 threads, one block per SM, two waves); no cluster
    (256 x C blocks would not be resident at once)."""
    plan = plan_multi_launch(5, nnodes, 125, 256, **kw)
    assert plan.cluster == 1
    assert plan.group in MULTI_GROUPS and plan.group <= 4
    assert plan.threads <= 512
    assert -(-256 // H100_SMS) == 2
    # two blocks per SM fit the register file at the kernel's bound (64
    # registers for G = 1 and G = 4), so the catalog is one wave
    assert 2 * plan.threads * 64 <= 65536
    assert h100_resident(plan) >= 256


@pytest.mark.parametrize("sms", [132, 16, 8])
def test_a_cluster_only_where_the_catalog_leaves_the_sms(sms):
    for nsrc in range(1, 3 * sms):
        for nnodes in (1, 65):
            plan = plan_multi_launch(5, nnodes, 125, nsrc, sm_count=sms)
            if plan.cluster > 1:
                assert nsrc * plan.cluster <= sms
                assert plan.group in MULTI_CLUSTER_GROUPS
            else:
                assert plan.group in MULTI_GROUPS


def test_a_small_catalog_takes_a_cluster_per_source():
    """Up to 16 sources on 132 SMs (by the model), each source on a cluster
    of 8 SMs, with the merge solve or with band nodes to split; then
    clusters of 4 up to 33 sources, and in response mode of 2 up to 66. The
    thin model with alpha fixed has neither, and keeps one thread per
    walker."""
    for nsrc in (1, 4, 16):
        for nnodes in (1, 65):
            assert plan_multi_launch(5, nnodes, 125, nsrc).cluster == 8
        assert plan_multi_launch(5, 1, 125, nsrc, noalpha=True).cluster == 8
        assert plan_multi_launch(5, 1, 125, nsrc, noalpha=True, opthin=True) \
            == stretch_plan(1, 1, 5, 1, 125)
    for nsrc in (17, 33):
        assert plan_multi_launch(5, 1, 125, nsrc) == stretch_plan(
            8, 4, 5, 1, 125)
        assert plan_multi_launch(5, 65, 125, nsrc) == stretch_plan(
            16, 4, 5, 65, 125)
    for nsrc in (34, 66):
        assert plan_multi_launch(5, 65, 125, nsrc) == stretch_plan(
            8, 2, 5, 65, 125)
    assert plan_multi_launch(5, 1, 125, 34).cluster == 1


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_many_sources_per_sm_plan_the_tables_entry(kw):
    """At 1024 sources (7.8 per SM) no layout but the table's last keeps
    the catalog one wave, and that is one thread per walker."""
    mode = plan_mode(1, **kw)
    assert MULTI_PLAN_TABLE[mode][-1] == (1, 1)
    plan = plan_multi_launch(5, 1, 125, 1024, **kw)
    assert plan == stretch_plan(1, 1, 5, 1, 125)
    assert plan_multi_launch(5, 65, 125, 1024) \
        == stretch_plan(1, 1, 5, 65, 125)


def test_the_table_keys_every_mode_by_load():
    """Every mode lists instantiated layouts, each once, and ends in one
    thread per walker, which takes any catalog."""
    assert set(MULTI_PLAN_TABLE) == {"point", "point_noalpha_thick",
                                     "point_noalpha_thin", "response"}
    for layouts in MULTI_PLAN_TABLE.values():
        assert layouts[-1] == (1, 1)
        assert len(set(layouts)) == len(layouts)
        for g, c in layouts:
            assert (g, c > 1) in MULTI_LAYOUTS
            assert 1 <= c <= MAX_CLUSTER


def test_the_plan_follows_the_card_size():
    """The load is sources per SM: the same catalog takes a cluster on a
    large card and one block per source on a small one."""
    assert plan_multi_launch(5, 1, 125, 8, sm_count=132).cluster > 1
    assert plan_multi_launch(5, 1, 125, 8, sm_count=16).cluster == 1


def test_plan_falls_back_when_shared_memory_is_short():
    """8 bands x 1000 nodes: a block of 512 threads takes 87,952 B, of 256
    79,760 B, of 128 75,664 B. A cluster halves its lanes down to 8, then
    the table's next layout is tried, and one thread per walker is the last
    resort."""
    assert run_smem_bytes(8, 1000, 125, 512) == 87952
    one_block = {lim: plan_multi_launch(8, 1000, 125, 256, smem_limit=lim)
                 for lim in (90000, 80000, 76000, 60000)}
    assert one_block[90000].group == 4
    assert one_block[80000] == stretch_plan(1, 1, 8, 1000, 125)
    assert one_block[76000] == stretch_plan(1, 1, 8, 1000, 125)
    assert one_block[60000] == stretch_plan(1, 1, 8, 1000, 125)
    group, cluster = MULTI_PLAN_TABLE["response"][0]
    clustered = {lim: plan_multi_launch(8, 1000, 125, 4, smem_limit=lim)
                 for lim in (90000, 80000, 76000, 70000)}
    assert (clustered[90000].group, clustered[90000].cluster) \
        == (group, cluster)
    assert clustered[76000].group == 8 and clustered[76000].cluster > 1
    assert clustered[70000] == stretch_plan(1, 1, 8, 1000, 125)


def test_larger_ensembles_take_fewer_lanes():
    """Response mode at 256 sources plans G = 4 lanes per walker at 250
    walkers; a block holds at most 512 grouped threads, so at 250 or 500
    walkers per half only one thread per walker fits."""
    assert plan_multi_launch(5, 65, 125, 256).group == 4
    assert plan_multi_launch(5, 65, 250, 256) \
        == stretch_plan(1, 1, 5, 65, 250)
    plan = plan_multi_launch(5, 65, 500, 256)
    assert (plan.group, plan.threads) == (1, 512)


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_point_mode_keeps_one_thread_per_walker_from_a_wave_up(kw):
    """In point mode lanes per walker in one block ran slower than one
    thread per walker at 4-1024 sources, and 2-block clusters gained under
    3% (chip_smoke.py's sweep): the table plans G = 1 beyond the 4-block
    clusters (33 sources on 132 SMs by the model)."""
    for nsrc in (34, 64, 132, 256, 264, 1024):
        assert plan_multi_launch(5, 1, 125, nsrc, **kw) \
            == stretch_plan(1, 1, 5, 1, 125)


NO_CLUSTER = {(g, c): 3 for g in MULTI_CLUSTER_GROUPS for c in (2, 4, 8)}


@pytest.mark.parametrize("args,mode,resident_of,want", [
    # 256 response sources where the card holds 255 blocks of G = 4
    ((5, 65, 125, 256), {}, {(4, 1): 255}, (1, 1)),
    # 4 response sources where no 8-block cluster of any lanes is placed 4
    # times, or no cluster at all
    ((5, 65, 125, 4), {}, {(32, 8): 3, (16, 8): 3, (8, 8): 3}, (16, 4)),
    ((5, 65, 125, 4), {}, NO_CLUSTER, (4, 1)),
    ((5, 65, 125, 4), {}, {(32, 8): 3, (16, 8): 4}, (16, 8)),
    # 16 point sources where the card places 15 groups of 8 SMs (an H100)
    ((5, 1, 125, 16), {}, {(8, 8): 15}, (8, 4)),
    ((5, 1, 125, 16), dict(noalpha=True), {(8, 8): 16}, (8, 8))],
    ids=["response-256-one-short", "response-4-no-8-cluster",
         "response-4-no-cluster", "response-4-fewer-lanes",
         "point-16-one-short", "thick-16-fits"])
def test_a_layout_is_planned_only_where_the_catalog_is_one_wave(
        args, mode, resident_of, want):
    """plan_multi_launch takes a layout only where the card (here a stand-in
    for mbb_multi_resident) holds every source at once; one wave short, it
    takes a cluster's fewer lanes or the next layout of the table."""
    asked = []

    def resident(plan):
        asked.append((plan.group, plan.cluster))
        return resident_of.get((plan.group, plan.cluster),
                               h100_resident(plan))
    plan = plan_multi_launch(*args, resident=resident, **mode)
    assert (plan.group, plan.cluster) == want
    assert plan == stretch_plan(*want, *args[:3])
    assert (1, 1) not in asked


@pytest.mark.parametrize("plan,per_sm", [
    (stretch_plan(1, 1, 5, 1, 125), 8),          # registers: 64 x 128
    (stretch_plan(4, 1, 5, 65, 125), 2),         # registers: 64 x 512
    (stretch_plan(4, 1, 8, 1000, 125), 2),       # 2 x 88 KB of shared memory
    (stretch_plan(4, 1, 8, 1500, 125), 1),       # 117 KB: one block per SM
    (stretch_plan(8, 8, 5, 1, 125), 1),          # a cluster: a block per SM
    (stretch_plan(32, 8, 5, 65, 125), 1),
    (stretch_plan(8, 2, 5, 65, 125), 1)])
def test_the_h100_model_counts_blocks_per_sm(plan, per_sm):
    """Off the card the planner counts what an H100 holds at once by CUDA's
    occupancy rules at the kernels' launch bounds, and a cluster of C
    blocks as one source on C SMs of its own."""
    assert h100_resident(plan) == H100_SMS * per_sm // plan.cluster
    assert h100_resident(plan, 16) == 16 * per_sm // plan.cluster


def test_on_the_h100s_own_counts_the_plan_is_the_sweeps_fastest():
    """With the counts an H100 (132 SMs) reported in chip_smoke.py phase 18
    (15 groups of 8 SMs, 30 of 4, 66 of 2; 264 blocks of G = 4 at 5 x 65)
    the planner picks, at each swept catalog size, the layout that ran
    fastest there, or one within 4% of it (PERF.md)."""
    placed = {8: 15, 4: 30, 2: 66}

    def resident(plan):
        return placed[plan.cluster] if plan.cluster > 1 \
            else h100_resident(plan)
    want = {(1, 4): (8, 8), (1, 16): (8, 4), (1, 32): (1, 1),
            (1, 64): (1, 1), (1, 256): (1, 1), (1, 1024): (1, 1),
            (65, 4): (32, 8), (65, 16): (16, 4), (65, 32): (8, 2),
            (65, 64): (8, 2), (65, 256): (4, 1), (65, 1024): (1, 1)}
    for (nnodes, nsrc), layout in want.items():
        plan = plan_multi_launch(5, nnodes, 125, nsrc, resident=resident)
        assert (plan.group, plan.cluster) == layout, (nnodes, nsrc)


def test_a_pack_that_halves_the_blocks_per_sm_keeps_one_thread_per_walker():
    """8 bands x 1500 nodes: a G = 4 block takes 117 KB of shared memory,
    so one fits an SM and 132 sources are one wave but 256 are not."""
    assert run_smem_bytes(8, 1500, 125, 512) > (233472 - 2 * 1024) // 2
    assert plan_multi_launch(8, 1500, 125, 132).group == 4
    assert plan_multi_launch(8, 1500, 125, 256) \
        == stretch_plan(1, 1, 8, 1500, 125)


WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([8.62, 23.3, 41.2, 44.6, 45.0])


def _sampler(nsrc=3):
    spec = LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = 100.0, 5.0
    flux = FLUX[None] * np.linspace(0.8, 1.2, nsrc)[:, None]
    unc = 0.05 * flux
    flux[1, 0] = unc[1, 0] = np.nan
    ul = np.zeros((nsrc, 5), bool)
    ul[0, 4] = True
    return FusedMultiSampler(16, WAVE, flux, unc, MBBShape(),
                             dataclasses.replace(spec, uplim_bands=ul),
                             device="cpu")


def _state(samp):
    p0 = make_initial_ball(torch.Generator().manual_seed(1),
                           [30.0, 1.8, 250.0, 3.5, 40.0],
                           [2.0, 0.1, 20.0, 0.3, 1.0], 16,
                           samp.free_space.lower, samp.free_space.upper)
    return samp.init_state(
        torch.stack([p0.roll(s, 0) for s in range(samp.nsources)]), seed=5)


GOOD = stretch_plan(4, 1, 5, 1, 8)


@pytest.mark.parametrize("bad,match", [
    (dataclasses.replace(GOOD, group=3), "group 3 not in"),
    (stretch_plan(8, 1, 5, 1, 8), "group 8 runs only in a cluster"),
    (stretch_plan(4, 2, 5, 1, 8), "group 4 runs only in one block"),
    (stretch_plan(2, 1, 5, 1, 8), "group 2 not in"),
    (stretch_plan(8, 16, 5, 1, 8), "cluster 16"),
    (dataclasses.replace(GOOD, walkers_per_block=4), "do not hold"),
    (dataclasses.replace(GOOD, threads=48), "multiple of 32"),
    (dataclasses.replace(GOOD, threads=1024,
                         smem_bytes=run_smem_bytes(5, 1, 8, 1024)), "512"),
    (dataclasses.replace(GOOD, smem_bytes=GOOD.smem_bytes + 4),
     "smem_bytes"),
    (dataclasses.replace(stretch_plan(1, 1, 5, 1, 8), threads=64,
                         smem_bytes=run_smem_bytes(5, 1, 8, 64)),
     "one block of one thread per walker runs 32 threads"),
    ((4, 1), "StretchPlan")])
def test_bad_multi_plan_is_refused_on_a_cpu_state(bad, match):
    samp = _sampler()
    state = _state(samp)
    runs = mbb_multi_stretch_run.launches
    with pytest.raises(ValueError, match=match):
        mbb_multi_stretch_run(state, samp.ops, 2, 1, plan=bad)
    assert mbb_multi_stretch_run.launches == runs


def test_k2_keeps_its_own_layouts():
    """K2's check is unchanged by K3's layouts: G = 4 is K3's, and
    K2 runs every group with or without a cluster."""
    with pytest.raises(ValueError, match="group 4 not in"):
        check_plan(stretch_plan(4, 1, 5, 1, 8), 5, 1, 8)
    check_plan(stretch_plan(8, 1, 5, 1, 8), 5, 1, 8)
    with pytest.raises(ValueError, match="group 8 runs only in a cluster"):
        check_plan(stretch_plan(8, 1, 5, 1, 8), 5, 1, 8, MULTI_LAYOUTS)


def test_a_plan_leaves_the_cpu_multi_run_unchanged():
    """On the CPU the plain multi run runs whatever the (valid) plan."""
    samp = _sampler()
    state = _state(samp)
    want = mbb_multi_stretch_run(state, samp.ops, 3, 2)
    plans = [plan_multi_launch(5, 1, 8, samp.nsources)]
    plans += [stretch_plan(g, 1, 5, 1, 8) for g in MULTI_GROUPS]
    plans += [stretch_plan(g, c, 5, 1, 8) for g in MULTI_CLUSTER_GROUPS
              for c in (2, 8)]
    for plan in plans:
        assert isinstance(plan, StretchPlan)
        got = mbb_multi_stretch_run(state, samp.ops, 3, 2, plan=plan)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert torch.equal(got[0].naccept, want[0].naccept)


# nvcc -Xptxas -v output in the form the CUDA 12 toolkit prints it (entry
# names cut after the template arguments, which is all the parser reads).
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z24mbb_multi_stretch_kernelILi4ELb0EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z24mbb_multi_stretch_kernelILi4ELb0EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Function properties for _Z9mbb_helperv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_Z18mbb_stretch_kernelILi32ELb0EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z18mbb_stretch_kernelILi32ELb0EEvPKf
    64 bytes stack frame, 72 bytes spill stores, 104 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 64 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z17mbb_lnprob_kernelPKfS0_Pfi9MbbConfig' for 'sm_90a'
ptxas info    : Function properties for _Z17mbb_lnprob_kernelPKfS0_Pfi9MbbConfig
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""


def test_ptxas_report_reads_each_instantiation():
    """chip_smoke.py phase 1 holds K3's planned layouts to 0 spill bytes on
    this report: one row per kernel entry, its template arguments decoded,
    and a device function's spills charged to no kernel."""
    rows = ptxas_report(PTXAS_LOG)
    assert rows == [
        {"kernel": "mbb_multi_stretch_kernel", "group": 4, "cluster": False,
         "registers": 64, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "mbb_stretch_kernel", "group": 32, "cluster": False,
         "registers": 64, "spill_stores": 72, "spill_loads": 104},
        {"kernel": "mbb_lnprob_kernel", "group": None, "cluster": None,
         "registers": 32, "spill_stores": 0, "spill_loads": 0}]
