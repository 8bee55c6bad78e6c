"""A ready-to-serve model file for `run_sed_tpu_torch`: submm photo-z
greybody (the torch twin of examples/photoz_model.py).

    run_sed_tpu_torch examples/photoz_model_torch.py catalog.txt out.h5 \\
        -w 128 -b 300 -n 800 --fixed alpha 3 --prior T 38 6 \\
        --get-lir --lir-zparam z --get-dustmass --summary --device cuda

(`--device cpu` runs the same fit on the CPU. `--lir-zparam z` is
REQUIRED with --get-lir here: it marginalizes L_IR over each sample's own
z; without it the CLI would use the catalog z column, which for a photo-z
catalog is a placeholder.)

Redshift is the SIXTH SAMPLED PARAMETER (rest-frame T and lambda0, CMB
corrections on); `--prior T mu sigma` is NOT optional in spirit -- the
data alone constrain T/(1+z) only (see mbb_emcee_tpu_torch/photoz.py), so
the temperature prior is what turns the degeneracy ridge into a z
posterior. MIXED catalogs (a spectroscopic subsample inside the photo-z
survey) add `--anchor-z SIGMA`: the catalog's z column becomes a
per-source Gaussian prior on the sampled z -- rows with a finite z are
pinned at it, `nan` rows stay free -- all in one batch.

After the fit, marginalize derived quantities over z in Python:

    from mbb_emcee_tpu_torch.photoz import compute_dustmass_batch
    mf.compute_lir(z_param="z")        # per-sample windows + D_L
    compute_dustmass_batch(mf)         # CMB contrast-aware masses

and infer the catalog's N(z) with the population tier:

    from mbb_emcee_tpu_torch import fit_population
    hf = fit_population(mf, params=("z",))
"""

from mbb_emcee_tpu_torch import photoz_mbb

MODEL = photoz_mbb(cmb=True, z_upper=10.0)
