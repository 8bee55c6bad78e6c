"""The port's batched lnprob (the plain version of the lnprob kernel) against
the JAX package's build_lnprob on the cases of tests/test_pallas.py, with
shared numpy inputs; plus the kernel operand packing."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu.likelihood import (  # noqa: E402
    LikelihoodSpec as JSpec, Photometry as JPhotometry,
    build_lnprob as j_build_lnprob)
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
from mbb_emcee_tpu_torch.convert import (  # noqa: E402
    photometry_from_arrays, spec_from_reference)
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    LNPROB_FLOOR, build_lnprob)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape)
from mbb_emcee_tpu_torch.ops.lnprob_kernel import (  # noqa: E402
    mbb_lnprob, prepare_lnprob_inputs)

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
# Port vs JAX: fp32 on both sides, same formulas, different op order and
# transcendental implementations (XLA:CPU vs torch's).
RTOL, ATOL = 1e-5, 1e-4


def _phot(cov=False):
    f = np.array([8.62, 23.3, 41.2, 44.6, 45.0])   # ~ the TRUE greybody
    unc = 0.05 * f
    flux = f + unc * np.random.default_rng(0).standard_normal(f.size)
    c = None
    if cov:
        calib = 0.04 * f
        c = np.outer(calib, calib) + np.diag(unc ** 2)
    return JPhotometry(WAVE, flux, unc, cov=c)


def _spec(opthin=False, noalpha=False):
    spec = JSpec.default()
    spec.upper[0] = 100.0
    spec.upper[1] = 5.0
    spec.prior_mean[2] = 250.0
    spec.prior_isigma[2] = 1.0 / 120.0
    if opthin:
        spec.fixed[2] = True
        spec.fixed_values[2] = 250.0
    if noalpha:
        spec.fixed[3] = True
        spec.fixed_values[3] = 3.5
    return spec


def _numpy_pack(nnodes=17):
    u = np.linspace(-0.2, 0.2, nnodes)
    nodes = WAVE[:, None] * np.exp(u)[None, :]
    w = np.full(nnodes, u[1] - u[0])
    w[[0, -1]] *= 0.5
    return nodes, np.broadcast_to(w / w.sum(), nodes.shape).copy()


def _walkers(free_idx, n=200, seed=1):
    """In-box and out-of-box walkers around TRUE (the spread of
    tests/test_pallas.py), plus rows pushed out of the box on purpose."""
    rng = np.random.default_rng(seed)
    w = TRUE[None, :] * rng.uniform(0.5, 1.8, (n, 5))
    w[:8, 0] = 150.0              # T above its upper limit
    w[8:16, 1] = -0.5             # beta below its lower limit
    return w[:, free_idx].astype(np.float32)


def _both(jphot, jshape, jspec, pack=None):
    """(port batched lnprob, JAX vmapped lnprob, free_idx) for one case,
    the port's inputs converted from the JAX objects."""
    j_fn, fs = j_build_lnprob(jphot, jshape, jspec, response_pack=pack)
    phot = photometry_from_arrays(jphot.wave, jphot.flux, jphot.unc,
                                  jphot.cov)
    shape = MBBShape(opthin=jshape.opthin, noalpha=jshape.noalpha,
                     wavenorm=jshape.wavenorm)
    t_fn, fs2 = build_lnprob(phot, shape, spec_from_reference(jspec),
                             response_pack=pack)
    np.testing.assert_array_equal(fs.free_idx, fs2.free_idx)
    return t_fn, jax.jit(jax.vmap(j_fn)), fs.free_idx


def _compare(t_fn, j_fn, x, rtol=RTOL, atol=ATOL):
    got = t_fn(torch.as_tensor(x)).numpy()
    want = np.asarray(j_fn(jnp.asarray(x)))
    floor = np.float32(LNPROB_FLOOR)
    np.testing.assert_array_equal(got == floor, want == floor)
    assert np.all(got[:16] == floor)          # the planted out-of-box rows
    m = want != floor
    assert m.sum() > 10
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)
    return got


CASES = {
    "diag-full5": dict(),
    "diag-thick4": dict(noalpha=True),
    "diag-thin3": dict(opthin=True, noalpha=True),
    "cov": dict(cov=True),
    "uplim": dict(uplim=True),
    "uplim-cov": dict(uplim=True, cov=True),
    "response-numpy-pack": dict(pack=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lnprob_matches_jax(case):
    kw = CASES[case]
    jshape = JShape(opthin=kw.get("opthin", False),
                    noalpha=kw.get("noalpha", False))
    jspec = _spec(kw.get("opthin", False), kw.get("noalpha", False))
    if kw.get("uplim"):
        ul = np.zeros(5, bool)
        ul[[0, 4]] = True
        jspec = dataclasses.replace(jspec, uplim_bands=ul)
    pack = _numpy_pack() if kw.get("pack") else None
    t_fn, j_fn, free_idx = _both(_phot(kw.get("cov", False)), jshape, jspec,
                                 pack)
    _compare(t_fn, j_fn, _walkers(free_idx))


def test_alpha_fixed_at_zero_matches_jax():
    """alpha fixed at 0, outside the default box: the clip window holds
    the fixed value, so the lnprob is finite, as in the JAX package."""
    jspec = JSpec.default()
    jspec.fixed[3] = True
    jspec.fixed_values[3] = 0.0
    t_fn, j_fn, free_idx = _both(_phot(), JShape(), jspec)
    rng = np.random.default_rng(5)
    th = (TRUE[free_idx][None, :]
          * rng.uniform(0.9, 1.1, (16, free_idx.size))).astype(np.float32)
    got = t_fn(torch.as_tensor(th)).numpy()
    want = np.asarray(j_fn(jnp.asarray(th)))
    assert np.all(got > LNPROB_FLOOR / 2) and np.all(want > LNPROB_FLOOR / 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_out_of_box_is_exactly_the_floor():
    t_fn, j_fn, free_idx = _both(_phot(), JShape(), _spec())
    th = np.tile(TRUE[free_idx], (6, 1)).astype(np.float32)
    th[0, 0], th[1, 0] = 0.05, 1e4          # T outside [0.1, 100]
    th[2, 1], th[3, 1] = 0.0, 7.0           # beta outside [0.01, 5]
    th[4, 4] = -1.0                         # fnorm below 1e-5
    th[5, 3] = 100.0                        # alpha above 60
    got = t_fn(torch.as_tensor(th)).numpy()
    want = np.asarray(j_fn(jnp.asarray(th)))
    assert np.all(got == np.float32(LNPROB_FLOOR))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("is_total", [False, True])
def test_read_cov_from_fits_matches_jax(tmp_path, is_total):
    """A calibration covariance written with the port's FITS writer reads
    back through both packages' Photometry.read_cov to the same matrix and
    the same lnprob."""
    from mbb_emcee_tpu_torch.utils.fits import write_fits_image
    f = _phot().flux
    calib = 0.05 * f
    cov = np.outer(calib, calib) * (0.5 + 0.5 * np.eye(5))
    if is_total:
        cov = cov + np.diag((0.05 * f) ** 2)
    path = tmp_path / "cov.fits"
    write_fits_image(path, cov)
    jphot = _phot()
    jphot.read_cov(str(path), is_total=is_total)
    phot = photometry_from_arrays(jphot.wave, jphot.flux, jphot.unc)
    phot.read_cov(path, is_total=is_total)
    np.testing.assert_array_equal(phot.cov, jphot.cov)
    t_fn, j_fn, free_idx = _both(jphot, JShape(), _spec())
    _compare(t_fn, j_fn, _walkers(free_idx))
    write_fits_image(tmp_path / "bad.fits", np.triu(cov))
    with pytest.raises(ValueError, match="symmetric"):
        phot.read_cov(tmp_path / "bad.fits")


def test_lnprob_matches_pallas_interpret():
    """One case against the JAX package's Pallas kernel in interpret mode,
    at tests/test_pallas.py's tolerance (the TPU kernel's series
    stand-ins for expm1/log1p are good to ~1e-6 relative per op)."""
    from mbb_emcee_tpu.ops.pallas_lnprob import build_pallas_lnprob
    jphot, jspec = _phot(cov=True), _spec()
    t_fn, _, free_idx = _both(jphot, JShape(), jspec)
    p_fn, _ = build_pallas_lnprob(jphot, JShape(), jspec, interpret=True)
    x = _walkers(free_idx, n=64)
    got = t_fn(torch.as_tensor(x)).numpy()
    want = np.asarray(p_fn(jnp.asarray(x)))
    np.testing.assert_array_equal(got <= LNPROB_FLOOR / 2,
                                  want <= LNPROB_FLOOR / 2)
    m = want > LNPROB_FLOOR / 2
    np.testing.assert_allclose(got[m], want[m], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("cov,uplim,pack", [
    (False, False, False), (True, True, False), (False, False, True)])
def test_kernel_operands_layout(cov, uplim, pack):
    """The packed constant buffer and config arrays follow the layout
    csrc/lnprob.cuh reads, and the CPU wrapper is the plain version."""
    jphot = _phot(cov)
    jspec = _spec(noalpha=True)
    if uplim:
        ul = np.zeros(5, bool)
        ul[[1, 4]] = True
        jspec = dataclasses.replace(jspec, uplim_bands=ul)
    rp = _numpy_pack() if pack else None
    phot = photometry_from_arrays(jphot.wave, jphot.flux, jphot.unc,
                                  jphot.cov)
    spec = spec_from_reference(jspec)
    ops = prepare_lnprob_inputs(phot, MBBShape(noalpha=True), spec, rp)
    c = ops.consts.numpy()
    nb, nn = 5, (rp[0].shape[1] if pack else 1)
    assert c.size == 20 + nb + nb * nb + 2 * nb * nn + nb
    lower = np.where(spec.fixed, spec.fixed_values - 1.0, spec.lower)
    upper = np.where(spec.fixed, spec.fixed_values + 1.0, spec.upper)
    np.testing.assert_array_equal(c[:5], lower.astype(np.float32))
    np.testing.assert_array_equal(c[5:10], upper.astype(np.float32))
    np.testing.assert_array_equal(c[15:20],
                                  spec.prior_isigma.astype(np.float32))
    np.testing.assert_array_equal(c[20:25], phot.flux.astype(np.float32))
    whiten = c[25:50].reshape(5, 5)
    if cov:
        np.testing.assert_allclose(whiten @ np.linalg.cholesky(phot.cov),
                                   np.eye(5), atol=1e-5)
    else:
        np.testing.assert_allclose(np.diag(whiten), 1.0 / phot.unc,
                                   rtol=1e-6)
    waves = c[50:50 + nb * nn].reshape(nb, nn)
    np.testing.assert_allclose(waves, rp[0] if pack else WAVE[:, None],
                               rtol=1e-6)
    np.testing.assert_array_equal(
        c[-nb:], [0, 1, 0, 0, 1] if uplim else np.zeros(nb))
    ic = ops.icfg
    assert list(ic[:6]) == [0, 1, int(cov), 5, nn, 4]
    assert list(ic[6:10]) == [0, 1, 2, 4]
    assert ops.fcfg[3] == np.float32(3.5)      # fixed alpha in the template
    x = torch.as_tensor(_walkers(ops.free_space.free_idx, n=32))
    assert torch.equal(mbb_lnprob(x, ops), ops.plain(x))
