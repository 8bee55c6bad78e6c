"""The PyTorch port's package boundary: it imports neither jax nor the JAX
package, builds its kernels only on demand (and says so clearly when nvcc is
missing), dispatches CPU tensors to the plain versions without touching the
kernel launch counters, and refuses the surfaces that are not ported yet
with the ROADMAP.md item that carries them."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu_torch import MBBFitter  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    LikelihoodSpec, Photometry)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape)
from mbb_emcee_tpu_torch.ops import build  # noqa: E402
from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob  # noqa: E402
from mbb_emcee_tpu_torch.ops.multifit_kernel import (  # noqa: E402
    FusedMultiSampler)
from mbb_emcee_tpu_torch.ops.sampler_kernel import (  # noqa: E402
    FusedSampler, mbb_stretch_run)
from mbb_emcee_tpu_torch.sampler import (  # noqa: E402
    make_initial_ball, multi_stretch_run_plain, stretch_run_plain)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mbb_emcee_tpu_torch"
WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([11.2, 32.1, 44.8, 38.2, 22.9])


def test_import_leaves_jax_and_reference_out():
    """In a fresh interpreter (this one already holds jax): importing the
    port, its CLIs, the batch tier, nested sampling, the population tier,
    the generic-model tier and its batch tier, forecasts, the CMB-corrected
    greybody, the photo-z model, the generic CLI and the plot helpers loads
    no jax, no mbb_emcee_tpu, no h5py and no matplotlib."""
    code = ("import sys, mbb_emcee_tpu_torch, mbb_emcee_tpu_torch.cli, "
            "mbb_emcee_tpu_torch.convert, mbb_emcee_tpu_torch.cli_batch, "
            "mbb_emcee_tpu_torch.catalog, mbb_emcee_tpu_torch.multifit, "
            "mbb_emcee_tpu_torch.batchengine, "
            "mbb_emcee_tpu_torch.ops.multifit_kernel, "
            "mbb_emcee_tpu_torch.checkpoint, mbb_emcee_tpu_torch.response, "
            "mbb_emcee_tpu_torch.instruments, mbb_emcee_tpu_torch.nested, "
            "mbb_emcee_tpu_torch.hierarchy, mbb_emcee_tpu_torch.sed, "
            "mbb_emcee_tpu_torch.forecast, mbb_emcee_tpu_torch.models.cmb, "
            "mbb_emcee_tpu_torch.sedmulti, mbb_emcee_tpu_torch.photoz, "
            "mbb_emcee_tpu_torch.cli_sed, mbb_emcee_tpu_torch.plotting\n"
            "bad = [m for m in ('jax', 'mbb_emcee_tpu', 'h5py', "
            "'matplotlib') "
            "if m in sys.modules]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_line_imports_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import mbb_emcee_tpu$|"
                     r"from mbb_emcee_tpu[ .])")
    offending = [f"{p.relative_to(REPO)}:{i}"
                 for p in sorted(PKG.rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pat.match(line)]
    assert offending == []


def test_build_kernels_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    build.build_kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build_kernels()
    finally:
        build.build_kernels.cache_clear()
    assert not list(tmp_path.iterdir())


def test_kernel_sources_are_packaged():
    names = sorted(p.name for p in (PKG / "csrc").iterdir())
    assert names == ["lnprob.cu", "lnprob.cuh", "multifit.cu", "sampler.cu",
                     "stretch.cuh"]


def _problem():
    phot = Photometry(WAVE, FLUX, 0.05 * FLUX)
    spec = LikelihoodSpec.default()
    spec.upper[0] = 100.0
    spec.upper[1] = 5.0
    return phot, MBBShape(), spec


def test_cpu_dispatch_leaves_launch_counters_at_zero():
    phot, shape, spec = _problem()
    k1, k2 = mbb_lnprob.launches, mbb_stretch_run.launches
    plain_runs = stretch_run_plain.runs
    samp = FusedSampler(16, phot, shape, spec, device="cpu")
    p0 = make_initial_ball(torch.Generator().manual_seed(0),
                           [30.0, 1.8, 250.0, 3.5, 23.0],
                           [2.0, 0.1, 20.0, 0.3, 1.0], 16,
                           samp.free_space.lower, samp.free_space.upper)
    state = samp.init_state(p0, seed=7)
    state, chain, lnp = samp.run_mcmc(state, 4, thin=2)
    assert chain.shape == (2, 16, 5) and lnp.shape == (2, 16)
    assert bool(torch.all(torch.isfinite(lnp)))
    assert mbb_lnprob.launches == k1
    assert mbb_stretch_run.launches == k2
    assert stretch_run_plain.runs == plain_runs + 1


@pytest.mark.parametrize("device,backend,want", [
    ("cpu", "auto", "torch"), ("cuda", "auto", "fused"),
    ("cpu", "fused", "fused"), ("cuda", "torch", "torch")])
def test_auto_backend_follows_the_device(device, backend, want,
                                        monkeypatch):
    # the choice follows the device's type alone; a CUDA device is refused
    # at construction without a card, so let the check see one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fit = MBBFitter(device=device, sampler_backend=backend)
    assert fit._resolve_sampler_backend() == want


@pytest.mark.parametrize("kwargs,item", [(dict(mesh=object()), "A11")])
def test_constructor_refuses_unported_options(kwargs, item, monkeypatch):
    """mesh= (ROADMAP A11, ported) takes a parallel.walker_mesh only: any
    other object is refused by name, and a device= that is not the mesh's
    first device conflicts with it."""
    from mbb_emcee_tpu_torch.parallel import walker_mesh
    with pytest.raises(TypeError, match="walker_mesh"):
        MBBFitter(device="cpu", **kwargs)
    cpu2 = walker_mesh(2, devices=["cpu"] * 2)
    assert MBBFitter(mesh=cpu2).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        MBBFitter(device="cuda", mesh=cpu2)


@pytest.mark.parametrize("surface", [
    "responses", "responses+n_ensembles", "checkpoint", "extend"])
def test_fitter_takes_the_ported_surfaces(tmp_path, surface):
    """Response mode (also through n_ensembles > 1), checkpointed runs and
    the single-ensemble extend run on the CPU."""
    from mbb_emcee_tpu_torch import ResponseSet
    names = ["PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350", "SPIRE_500"]
    kw = {}
    if surface.startswith("responses"):
        kw["responses"] = ResponseSet.builtin(names, nnodes=17)
    if surface.endswith("n_ensembles"):
        kw["n_ensembles"] = 2
    fit = MBBFitter(nwalkers=16, device="cpu", **kw)
    fit.set_data(WAVE, FLUX, 0.05 * FLUX, band_names=names)
    ck = str(tmp_path / "c.h5") if surface == "checkpoint" else None
    fit.run(nburn=4, nsteps=8, checkpoint=ck, checkpoint_interval=4)
    if surface == "extend":
        fit.extend(4)
    assert fit.chain.shape == (16 * kw.get("n_ensembles", 1),
                               12 if surface == "extend" else 8, 5)
    assert np.all(np.isfinite(fit.lnprobability.numpy()))
    if surface == "checkpoint":
        assert Path(ck).is_file()
    if "responses" in kw:
        assert np.isfinite(fit(np.array([30.0, 1.8, 250.0, 3.5, 23.0])))


# Names of mbb_emcee_tpu.__all__ the port does not export yet, each with
# the ROADMAP.md queue-A item that carries it.
WAITING_NAMES = {}


def test_every_reference_name_is_exported():
    """Every name in the JAX package's __all__ (read from its source: that
    package imports jax) is in the port's __all__ and importable from it,
    or waits on a named item of WAITING_NAMES."""
    import ast
    import mbb_emcee_tpu_torch as T
    tree = ast.parse((REPO / "mbb_emcee_tpu" / "__init__.py").read_text())
    ref = next(ast.literal_eval(n.value) for n in tree.body
               if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "__all__"
                       for t in n.targets))
    missing = sorted(set(ref) - set(T.__all__) - set(WAITING_NAMES))
    assert missing == []
    assert all(hasattr(T, n) for n in T.__all__)
    assert not set(WAITING_NAMES) & set(T.__all__)


@pytest.mark.parametrize("kwargs,accepted", [
    (dict(dtype=np.float32), True), (dict(dtype="float32"), True),
    (dict(dtype=torch.float32), True), (dict(dtype=np.float64), False),
    (dict(dtype=torch.float64), False), (dict(dtype="bfloat16"), False),
    (dict(prng_impl="rbg"), True),
    (dict(prng_impl="philox4x32_10"), True),
    (dict(prng_impl="threefry2x32"), False),
    (dict(lnprob_backend="xla"), True),
    (dict(lnprob_backend="pallas"), False)],
    ids=lambda v: str(v) if not isinstance(v, dict) else
    "-".join(f"{k}={getattr(x, '__name__', x)}" for k, x in v.items()))
@pytest.mark.parametrize("cls", ["MBBFitter", "MultiFitter"])
def test_jax_constructor_keywords_are_taken_by_name(cls, kwargs, accepted):
    """dtype=, prng_impl= and lnprob_backend= of the JAX constructors: the
    JAX default or the port's own value is taken; a value the port cannot
    honour (float64, another generator, the TPU kernel backend) raises a
    ValueError naming the keyword and what the port does instead, never a
    bare TypeError."""
    import mbb_emcee_tpu_torch as T
    make = getattr(T, cls)
    if accepted:
        make(nwalkers=16, device="cpu", **kwargs)
        return
    (key,) = kwargs
    with pytest.raises(ValueError, match=rf"{key}=.*(float32|Philox|"
                                         rf"device)"):
        make(nwalkers=16, device="cpu", **kwargs)


def test_no_refusal_names_a2_or_a4():
    """Response mode (A2) and checkpoint/resume/extend (A4) are ported:
    no refusal in the package or its CLIs names those items any more."""
    pat = re.compile(r'"A[24]"')
    offending = [f"{p.relative_to(REPO)}:{i}"
                 for p in sorted(PKG.rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pat.search(line)]
    assert offending == []


@pytest.mark.parametrize("call,nlive", [
    (lambda f: f.compute_evidence(nlive=64, max_iter=4), 64),
    (lambda f: f.compute_evidence(nlive=64, max_iter=4, verbose=True), 64),
    (lambda f: f.compute_evidence(max_iter=2), 512)])
def test_fitter_compute_evidence_runs(call, nlive):
    """compute_evidence (nested sampling, once refused as A9e) runs on the
    CPU's plain likelihood: here cut short by max_iter, so it warns and
    reports converged=False, with its samples in the full 5-parameter
    space and stored on the fitter."""
    fit = MBBFitter(nwalkers=16, device="cpu")
    fit.set_data(WAVE, FLUX, 0.05 * FLUX)
    with pytest.warns(UserWarning, match="max_iter"):
        ev = call(fit)
    assert fit.evidence is ev and not ev.converged
    assert ev.samples.shape == (ev.n_iter * 32 + nlive, 5)
    assert np.isfinite(ev.logz)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """On a CUDA machine: K1, K2 and K3 against their plain versions at the
    main path's walker count (chip_smoke.py runs the full set of cases).
    This file imports no jax, so it runs on a machine without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    phot, shape, spec = _problem()
    samp = FusedSampler(250, phot, shape, spec, rng="external",
                        device="cuda")
    p0 = make_initial_ball(torch.Generator().manual_seed(1),
                           [30.0, 1.8, 250.0, 3.5, 23.0],
                           [2.0, 0.1, 20.0, 0.3, 1.0], 250,
                           samp.free_space.lower, samp.free_space.upper,
                           device="cuda")
    torch.testing.assert_close(mbb_lnprob(p0, samp.ops),
                               samp.ops.plain(p0), rtol=1e-5, atol=1e-4)
    # a 5 x 129 built-in response pack (above the kernels' former cap)
    from mbb_emcee_tpu_torch import ResponseSet
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import prepare_lnprob_inputs
    names = ["PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350", "SPIRE_500"]
    ops = prepare_lnprob_inputs(
        phot, shape, spec, ResponseSet.builtin(names, nnodes=129).pack(names),
        device="cuda")
    # 129-term band sums, added in another order by torch's reduction
    torch.testing.assert_close(mbb_lnprob(p0, ops), ops.plain(p0),
                               rtol=2e-5, atol=1e-4)
    state = samp.init_state(p0, seed=3)
    u = torch.rand((3, 12, 125), generator=torch.Generator().manual_seed(2))
    u = u.clamp(1e-3, 1 - 1e-3).to("cuda")
    got = samp.run_mcmc(state, 6, thin=2, uniforms=u)
    want = stretch_run_plain(state, samp.ops.plain, 3, 2, 2.0, u)
    torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=1e-5)
    assert torch.equal(got[0].naccept, want[0].naccept)

    # K3: 3 sources, per-source upper limits and a missing band
    flux = np.stack([FLUX * f for f in (0.8, 1.0, 1.3)])
    unc = 0.05 * flux
    flux[1, 0] = unc[1, 0] = np.nan
    ul = np.zeros((3, 5), bool)
    ul[0, 4] = ul[2, 1] = True
    multi = FusedMultiSampler(250, WAVE, flux, unc, shape,
                              dataclasses.replace(spec, uplim_bands=ul),
                              rng="external", device="cuda")
    mstate = multi.init_state(torch.stack([p0, p0.flip(0), p0.roll(7, 0)]),
                              seed=3)
    u3 = torch.rand((3, 3, 12, 125),
                    generator=torch.Generator().manual_seed(4))
    u3 = u3.clamp(1e-3, 1 - 1e-3).to("cuda")
    got = multi.run_mcmc(mstate, 6, thin=2, uniforms=u3)
    want = multi_stretch_run_plain(mstate, multi.ops.plain, 3, 2, 2.0, u3)
    torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=1e-5)
    assert torch.equal(got[0].naccept, want[0].naccept)


@pytest.mark.cuda
def test_lnprob_layouts_agree_on_the_card():
    """On a CUDA machine: K1 on every lanes-per-vector layout, in blocks of
    one to eight warps, with a block per tile and with blocks that loop
    over the tiles, against one thread per vector in blocks of 128: bitwise
    in point mode at 1, 33, 250 and 4096 vectors, within tolerance on a
    5 x 65 response pack; the planned layout agrees with the plain version;
    the planner's shared-memory size is the library's; a layout the kernel
    lacks is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mbb_emcee_tpu_torch import ResponseSet
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
        LNPROB_GROUPS, lnprob_plan, plan_lnprob_on_card,
        prepare_lnprob_inputs)
    phot, shape, spec = _problem()
    names = ["PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350", "SPIRE_500"]
    pack = ResponseSet.builtin(names, nnodes=65).pack(names)
    rng = np.random.default_rng(8)
    xs = torch.as_tensor((np.array([30.0, 1.8, 250.0, 3.5, 23.0])[None]
                          * rng.uniform(0.7, 1.3, (4096, 5))).astype(
        np.float32), device="cuda")
    for rp, nn in ((None, 1), (pack, 65)):
        ops = prepare_lnprob_inputs(phot, shape, spec, rp, device="cuda")
        for n in (1, 33, 250, 4096):
            x = xs[:n].contiguous()
            want = mbb_lnprob(x, ops, plan=lnprob_plan(1, 128, n, 5, nn))
            planned = plan_lnprob_on_card(5, nn, n, False, False, 0)
            torch.testing.assert_close(mbb_lnprob(x, ops), ops.plain(x),
                                       rtol=1e-5, atol=1e-4)
            assert planned.group > 1
            for g in LNPROB_GROUPS:
                for t in (32, 128, 256):
                    for max_blocks in (None, 3):
                        p = lnprob_plan(g, t, n, 5, nn, max_blocks)
                        assert build.build_kernels().mbb_lnprob_smem_bytes(
                            5, nn, t) == p.smem_bytes
                        got = mbb_lnprob(x, ops, plan=p)
                        if rp is None:
                            assert torch.equal(got, want), p
                        else:
                            torch.testing.assert_close(got, want, rtol=1e-5,
                                                       atol=1e-4)
    with pytest.raises(ValueError, match="group 2"):
        mbb_lnprob(xs, ops, plan=dataclasses.replace(
            lnprob_plan(4, 128, 4096, 5, 65), group=2))


@pytest.mark.cuda
def test_stretch_layouts_agree_on_the_card():
    """On a CUDA machine: K2 on its planned layout (lanes per walker in a
    thread-block cluster) and on every other layout of the planner's sweep
    against the one-thread-per-walker layout, point mode, Philox stream:
    bitwise; and the planner's shared-memory size is the library's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mbb_emcee_tpu_torch.ops.sampler_kernel import (
        max_threads, plan_stretch_launch, stretch_plan)
    phot, shape, spec = _problem()
    samp = FusedSampler(250, phot, shape, spec, device="cuda")
    p0 = make_initial_ball(torch.Generator().manual_seed(1),
                           [30.0, 1.8, 250.0, 3.5, 23.0],
                           [2.0, 0.1, 20.0, 0.3, 1.0], 250,
                           samp.free_space.lower, samp.free_space.upper,
                           device="cuda")
    state = samp.init_state(p0, seed=9)
    plan = plan_stretch_launch(5, 1, 125)
    assert plan.group > 1 and plan.cluster > 1
    want = mbb_stretch_run(state, samp.ops, 10, 3,
                           plan=stretch_plan(1, 1, 5, 1, 125))
    for g in (1, 8, 16, 32):
        for c in (1, 2, 4, 8):
            p = stretch_plan(g, c, 5, 1, 125)
            if p.threads > max_threads(g):
                continue
            assert build.build_kernels().mbb_run_smem_bytes(
                5, 1, 125, p.threads) == p.smem_bytes
            got = mbb_stretch_run(state, samp.ops, 10, 3, plan=p)
            assert torch.equal(got[1], want[1]), p
            assert torch.equal(got[2], want[2]), p
            assert torch.equal(got[0].naccept, want[0].naccept), p


@pytest.mark.cuda
def test_multi_layouts_agree_on_the_card():
    """On a CUDA machine: K3 on every layout of its planner's table
    (MULTI_PLAN_TABLE, every mode) and the layout it plans on this card for
    4 and for 256 sources against one thread per walker (G = 1, C = 1),
    point mode with per-source upper limits and a missing band, Philox
    streams: chains, lnprob and accepts bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mbb_emcee_tpu_torch.ops.multifit_kernel import (
        MULTI_PLAN_TABLE, device_sm_count, mbb_multi_stretch_run,
        plan_multi_on_card)
    from mbb_emcee_tpu_torch.ops.sampler_kernel import stretch_plan
    phot, shape, spec = _problem()
    layouts = {lay for lays in MULTI_PLAN_TABLE.values() for lay in lays}
    sms = device_sm_count(0)
    for nsrc in (4, 256):
        flux = FLUX[None] * np.linspace(0.8, 1.2, nsrc)[:, None]
        unc = 0.05 * flux
        flux[1::3, 0] = unc[1::3, 0] = np.nan
        ul = np.zeros((nsrc, 5), bool)
        ul[::4, 4] = True
        multi = FusedMultiSampler(250, WAVE, flux, unc, shape,
                                  dataclasses.replace(spec, uplim_bands=ul),
                                  device="cuda")
        p0 = make_initial_ball(torch.Generator().manual_seed(1),
                               [30.0, 1.8, 250.0, 3.5, 23.0],
                               [2.0, 0.1, 20.0, 0.3, 1.0], 250,
                               multi.free_space.lower, multi.free_space.upper,
                               device="cuda")
        state = multi.init_state(
            torch.stack([p0.roll(s, 0) for s in range(nsrc)]), seed=9)
        want = mbb_multi_stretch_run(state, multi.ops, 10, 3,
                                     plan=stretch_plan(1, 1, 5, 1, 125))
        plans = {plan_multi_on_card(5, 1, 125, nsrc, False, False, 0)}
        plans |= {stretch_plan(g, c, 5, 1, 125) for g, c in layouts
                  if nsrc * c <= sms}
        for p in plans:
            got = mbb_multi_stretch_run(state, multi.ops, 10, 3, plan=p)
            assert torch.equal(got[1], want[1]), p
            assert torch.equal(got[2], want[2]), p
            assert torch.equal(got[0].naccept, want[0].naccept), p
