"""The port's upstream-schema HDF5 import (mbb_emcee_tpu_torch/legacy_h5.py)
on the CPU: twins of tests/test_legacy_h5.py through the port's
MBBResults, compat.mbb_results and mbb_tpu_inspect_torch, and the payload
of every synthesized layout against the JAX reader's on the same file.

As in tests/test_legacy_h5.py, the files are SYNTHESIZED in the
reconstructed upstream `mbb_emcee.mbb_results.writeToHDF5` layout
(SURVEY.md C7 [MED schema confidence]) and in deliberately mangled
variants; nothing is downloaded."""

import dataclasses
import sys
import warnings

import h5py
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import legacy_h5 as jlegacy  # noqa: E402
from mbb_emcee_tpu_torch import MBBResults  # noqa: E402
from mbb_emcee_tpu_torch import legacy_h5  # noqa: E402
from mbb_emcee_tpu_torch.legacy_h5 import (  # noqa: E402
    UpstreamSchemaError, read_upstream_results)

NW, NS = 16, 40
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
SCATTER = np.array([1.5, 0.1, 20.0, 0.3, 2.0])


def _chain(rng, fixed_cols=()):
    chain = TRUE + SCATTER * rng.standard_normal((NW, NS, 5))
    for c in fixed_cols:
        chain[:, :, c] = TRUE[c]
    return chain


def _write_canonical(path, rng):
    """The highest-confidence layout guess: flat root datasets with the
    upstream's own names, settings as root attrs."""
    chain = _chain(rng)
    with h5py.File(path, "w") as f:
        f.attrs["z"] = 2.5
        f.attrs["opthin"] = False
        f.attrs["noalpha"] = False
        f.attrs["wavenorm"] = 500.0
        f.create_dataset("chain", data=chain)
        f.create_dataset("lnprobability",
                         data=-0.5 * rng.chisquare(3, (NW, NS)))
        f.create_dataset("wave", data=[100.0, 250.0, 500.0])
        f.create_dataset("flux", data=[10.0, 40.0, 20.0])
        f.create_dataset("flux_unc", data=[1.0, 2.0, 1.5])
    return chain


def _write_alternate(path, rng):
    """Lower-confidence names, nested groups, a flattened chain."""
    chain = _chain(rng)
    with h5py.File(path, "w") as f:
        g = f.create_group("mcmc")
        g.create_dataset("samples", data=chain.reshape(-1, 5))
        g.create_dataset("lnlike", data=-0.5 * rng.chisquare(3, (NW, NS)))
        d = f.create_group("data")
        d.create_dataset("wavelength", data=[250.0, 350.0])
        d.create_dataset("fnu", data=[40.0, 30.0])
        d.create_dataset("sigma", data=[2.0, 2.0])
        f.attrs["redshift"] = 1.2
    return chain


def _write_flat_nwalkers(path, rng):
    chain = _chain(rng)
    with h5py.File(path, "w") as f:
        f.attrs["nwalkers"] = NW
        f.attrs["z"] = 2.0
        f.create_dataset("chain", data=chain.reshape(-1, 5))
    return chain


def _write_flat_iterations(path, rng):
    chain = _chain(rng)
    with h5py.File(path, "w") as f:
        f.attrs["iterations"] = NS
        f.create_dataset("samples", data=chain.reshape(-1, 5))
    return chain


def _write_bad_phot(path, rng):
    chain = _chain(rng)
    with h5py.File(path, "w") as f:
        f.create_dataset("chain", data=chain)
        f.create_dataset("wave", data=[100.0, 250.0, 500.0])
        f.create_dataset("flux", data=[10.0, 40.0])          # 2 != 3
        f.create_dataset("flux_unc", data=[1.0, 2.0, 1.5, 0.9])  # 4 != 3
    return chain


def _write_transposed(path, rng):
    chain = _chain(rng)
    with h5py.File(path, "w") as f:
        f.create_dataset("chain", data=np.moveaxis(chain, 2, 0))
    return chain


def _write_reduced(path, rng):
    """An opthin+noalpha file storing only the 3 free columns."""
    free = [0, 1, 4]
    chain3 = (TRUE[free]
              + SCATTER[free] * rng.standard_normal((NW, NS, 3)))
    with h5py.File(path, "w") as f:
        f.attrs["opthin"] = True
        f.attrs["noalpha"] = True
        f.attrs["z"] = 3.0
        f.create_dataset("chain", data=chain3)
    return chain3


def _write_zero_variance(path, rng):
    chain = _chain(rng, fixed_cols=(3,))
    with h5py.File(path, "w") as f:
        f.create_dataset("chain", data=chain)
    return chain


def _write_derived_cov_limits(path, rng):
    """Derived chains, a covariance, box limits and a lumdist attr, on a
    group attr rather than the root."""
    chain = _chain(rng)
    with h5py.File(path, "w") as f:
        g = f.create_group("results")
        g.attrs["lumdist"] = 1.7e4
        g.attrs["lowlim"] = [1.0, 0.1, 10.0, 0.5, 1e-3]
        g.attrs["uplim"] = [90.0, 4.0, 900.0, 9.0, 1e4]
        g.create_dataset("chain", data=chain)
        g.create_dataset("lnprob", data=-0.5 * rng.chisquare(3, (NW, NS)))
        f.create_dataset("wave", data=[250.0, 350.0, 500.0])
        f.create_dataset("flux", data=[40.0, 30.0, 20.0])
        f.create_dataset("flux_unc", data=[2.0, 2.0, 1.5])
        f.create_dataset("covmatrix", data=np.diag([4.0, 4.0, 2.25]))
        f.create_dataset("lir", data=rng.lognormal(29, 0.2, NW * NS))
        f.create_dataset("dustmass", data=rng.lognormal(19, 0.2, NW * NS))
        f.create_dataset("peaklambda", data=rng.normal(100, 5, NW * NS))
    return chain


LAYOUTS = {
    "canonical": _write_canonical, "alternate": _write_alternate,
    "flat_nwalkers": _write_flat_nwalkers,
    "flat_iterations": _write_flat_iterations, "bad_phot": _write_bad_phot,
    "transposed": _write_transposed, "reduced": _write_reduced,
    "zero_variance": _write_zero_variance,
    "derived_cov_limits": _write_derived_cov_limits,
}


def test_canonical_layout_loads_with_audit_warning(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "legacy.h5")
    chain = _write_canonical(path, rng)
    with pytest.warns(UserWarning, match="UPSTREAM-layout"):
        res = MBBResults(h5file=path, device="cpu")
    assert res.chain.shape == (NW, NS, 5)
    np.testing.assert_allclose(res.chain, chain)
    assert res.redshift == 2.5
    assert res.nwalkers == NW
    # posterior summaries work
    med, up, dn = res.par_cen("T")
    assert abs(med - TRUE[0]) < 1.0
    # best_fit uses the imported lnprob
    params, lnp = res.best_fit
    assert np.isfinite(lnp)
    # photometry came through
    np.testing.assert_allclose(res.data_wave, [100.0, 250.0, 500.0])
    # diagnostics on the free columns
    assert np.isfinite(res.gelman_rubin()).all()


def test_derived_quantities_compute_from_imported_chain(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "legacy.h5")
    _write_canonical(path, rng)
    with pytest.warns(UserWarning):
        res = MBBResults(h5file=path, device="cpu")
    lir = res.compute_lir(thin=4)
    assert lir.shape[0] == NW * NS // 4
    assert np.all(np.isfinite(lir)) and np.all(lir > 0)
    pl = res.compute_peaklambda(thin=4)
    assert np.all((pl > 50.0) & (pl < 500.0))


def test_alternate_names_and_nesting(tmp_path):
    """Lower-confidence guesses: different dataset names, nested groups,
    flattened chain; the audit warning must mark guessed mappings."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "odd.h5")
    chain = _write_alternate(path, rng)
    with pytest.warns(UserWarning, match="guessed"):
        payload = read_upstream_results(path)
    # walker count recovered from the matching lnprob shape
    assert payload["chain"].shape == (NW, NS, 5)
    np.testing.assert_allclose(payload["chain"], chain)
    assert payload["redshift"] == 1.2
    np.testing.assert_allclose(payload["phot"].wave, [250.0, 350.0])


def test_flatchain_with_nwalkers_attr_recovers_walker_axis(tmp_path):
    """An emcee-style flatchain (no lnprob) carrying an nwalkers attr folds
    into the true (nwalkers, nsteps, 5) geometry, so walker-wise
    diagnostics stay meaningful."""
    rng = np.random.default_rng(9)
    path = str(tmp_path / "flat_nw.h5")
    chain = _write_flat_nwalkers(path, rng)
    with pytest.warns(UserWarning, match="nwalkers attr"):
        res = MBBResults(h5file=path, device="cpu")
    assert res.chain.shape == (NW, NS, 5)
    np.testing.assert_allclose(res.chain, chain)
    rhat = res.gelman_rubin()
    assert np.isfinite(rhat).all()
    assert np.isfinite(res.effective_samples()).all()


def test_flatchain_with_iterations_attr_recovers_walker_axis(tmp_path):
    rng = np.random.default_rng(10)
    path = str(tmp_path / "flat_it.h5")
    chain = _write_flat_iterations(path, rng)
    with pytest.warns(UserWarning, match="iterations attr"):
        payload = read_upstream_results(path)
    assert payload["chain"].shape == (NW, NS, 5)
    np.testing.assert_allclose(payload["chain"], chain)


def test_mismatched_photometry_lengths_degrade_with_note(tmp_path):
    """flux/unc arrays whose length disagrees with wave degrade to NaN
    placeholders with an audit note, not a crash in Photometry."""
    rng = np.random.default_rng(11)
    path = str(tmp_path / "badphot.h5")
    _write_bad_phot(path, rng)
    with pytest.warns(UserWarning, match="does not match"):
        payload = read_upstream_results(path)
    phot = payload["phot"]
    assert phot.wave.size == 3
    assert np.isnan(phot.flux).all() and np.isnan(phot.unc).all()


def test_transposed_chain_axis_located(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "transposed.h5")
    chain = _write_transposed(path, rng)
    with pytest.warns(UserWarning, match="moved last"):
        payload = read_upstream_results(path)
    np.testing.assert_allclose(payload["chain"], chain)


def test_reduced_columns_expand_via_model_flags(tmp_path):
    """An opthin+noalpha file storing only the 3 free columns maps onto
    the full 5-parameter layout with the fixed mask set."""
    rng = np.random.default_rng(5)
    free = [0, 1, 4]
    path = str(tmp_path / "reduced.h5")
    chain3 = _write_reduced(path, rng)
    with pytest.warns(UserWarning, match="expanded"):
        res = MBBResults(h5file=path, device="cpu")
    assert res.chain.shape == (NW, NS, 5)
    np.testing.assert_allclose(res.chain[:, :, free], chain3)
    assert res.param_spec.fixed[2] and res.param_spec.fixed[3]
    assert res.free_param_names == ["T", "beta", "fnorm"]


def test_zero_variance_columns_marked_fixed(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "fixedcol.h5")
    _write_zero_variance(path, rng)
    with pytest.warns(UserWarning, match="fixed parameters inferred"):
        res = MBBResults(h5file=path, device="cpu")
    assert res.param_spec.fixed[3]
    assert res.param_spec.fixed_values[3] == pytest.approx(TRUE[3])
    assert "alpha" not in res.free_param_names


def test_unrecognizable_file_names_what_was_wanted(tmp_path):
    path = str(tmp_path / "junk.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("unrelated", data=np.arange(4.0))
    with pytest.raises(UpstreamSchemaError) as ei:
        read_upstream_results(path)
    msg = str(ei.value)
    assert "chain" in msg and "unrelated" in msg and "ParamConfig" in msg
    # and through the public constructor too
    with pytest.raises(UpstreamSchemaError):
        MBBResults(h5file=path, device="cpu")
    # the JAX reader refuses it with the same message
    with pytest.raises(jlegacy.UpstreamSchemaError) as jei:
        jlegacy.read_upstream_results(path)
    assert str(jei.value) == msg


def test_native_files_bypass_the_legacy_reader(tmp_path):
    """A file the port wrote loads through hdf5io with NO upstream-import
    warning (regression guard on the sniffing)."""
    from mbb_emcee_tpu_torch import MBBFitter
    fit = MBBFitter(nwalkers=12, seed=0, opthin=True, noalpha=True,
                    device="cpu")
    fit.set_data(np.array([100.0, 250.0, 500.0]),
                 np.array([10.0, 40.0, 20.0]), np.array([1.0, 2.0, 1.5]))
    fit.run(nburn=8, nsteps=12)
    path = str(tmp_path / "native.h5")
    res = MBBResults(fit=fit, redshift=2.0)
    res.writeToHDF5(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        res2 = MBBResults(h5file=path, device="cpu")
    np.testing.assert_allclose(res2.chain, res.chain)


def test_compat_surface_reads_upstream_files(tmp_path):
    """The migration story end-to-end: upstream-named compat class,
    upstream-layout file."""
    from mbb_emcee_tpu_torch.compat import mbb_results
    rng = np.random.default_rng(7)
    path = str(tmp_path / "legacy.h5")
    _write_canonical(path, rng)
    with pytest.warns(UserWarning, match="UPSTREAM-layout"):
        res = mbb_results(h5file=path, device="cpu")
    med, _, _ = res.par_cen("beta")
    assert abs(med - TRUE[1]) < 0.2


def test_cli_inspect_reports_upstream_kind(tmp_path, capsys):
    from mbb_emcee_tpu_torch.cli_inspect import inspect_file, main
    rng = np.random.default_rng(8)
    path = str(tmp_path / "legacy.h5")
    with h5py.File(path, "w") as f:
        f.attrs["z"] = 2.5
        f.create_dataset("chain", data=_chain(rng))
        f.create_dataset("lnprobability",
                         data=-0.5 * rng.chisquare(3, (NW, NS)))
        f.create_dataset("lir", data=rng.lognormal(29, 0.2, NW * NS))
    info = inspect_file(path)
    assert info["kind"] == "upstream"
    assert info["nwalkers"] == NW and info["nsteps"] == NS
    names = [row["name"] for row in info["params"]]
    assert names == ["T", "beta", "lambda0", "alpha", "fnorm"]
    assert info["derived"][0]["name"] == "L_IR"
    assert main([path]) == 0
    out = capsys.readouterr().out
    assert "upstream" in out and "T = " in out


def _read_both(path):
    """(port payload, its warning messages, JAX payload, its messages)."""
    out = []
    for reader in (read_upstream_results, jlegacy.read_upstream_results):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            payload = reader(path)
        out += [payload, [str(w.message) for w in got
                          if issubclass(w.category, UserWarning)]]
    return out


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same(got, want, where):
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_payload_matches_the_jax_reader(layout, tmp_path):
    """Every synthesized layout through both packages' readers: every
    array exactly, every scalar and flag, the Photometry / MBBShape /
    LikelihoodSpec fields, and the audit warnings as the same strings."""
    path = str(tmp_path / f"{layout}.h5")
    LAYOUTS[layout](path, np.random.default_rng(100 + len(layout)))
    got, got_msgs, want, want_msgs = _read_both(path)
    assert got_msgs == want_msgs and len(got_msgs) == 1
    assert sorted(got) == sorted(want)
    for key in want:
        if key in ("phot", "shape", "param_spec"):
            a, b = _fields(got[key]), _fields(want[key])
            assert sorted(a) == sorted(b), key
            for name in b:
                _assert_same(a[name], b[name], f"{key}.{name}")
        else:
            _assert_same(got[key], want[key], key)


def test_readers_need_h5py_by_name(tmp_path, monkeypatch):
    """Importing the module needs no h5py; reading without it raises an
    ImportError that names it."""
    path = str(tmp_path / "legacy.h5")
    _write_canonical(path, np.random.default_rng(12))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        legacy_h5.read_upstream_results(path)
    from mbb_emcee_tpu_torch.cli_inspect import inspect_file
    with pytest.raises(ImportError, match="h5py"):
        inspect_file(path)
