"""A ready-to-serve model file for `run_sed_tpu_torch`: CMB-corrected
greybody (the torch twin of examples/cmb_high_z_model.py).

    run_sed_tpu_torch examples/cmb_high_z_model_torch.py catalog.txt out.h5 \\
        -w 128 -b 200 -n 600 --fixed lambda0 100 --fixed alpha 3 \\
        --lowlim T 10 --uplim T 60 --get-lir --ppc --summary --device cuda

(`--device cpu` runs the same fit on the CPU.)

The `--lowlim T` matters: below ~0.6 T_CMB(z) (T_CMB(5) = 16.4 K) the
equilibrium temperature saturates at the CMB floor and the likelihood
goes exactly flat in T, so walkers that wander there mix glacially.
Bound it out (as above) or use `--pt` to hop the plateau.

For cold dust at z of a few and beyond, the CMB both HEATS the grains
(T_dust cannot fall below T_CMB(z) = 2.725 (1+z) K) and is the
BACKGROUND the photometry is measured against; ignoring it biases T low
and dust masses high (da Cunha et al. 2013). `cmb_corrected_mbb` bakes
both corrections into a generic-tier model at a fixed redshift --
change Z below (or build models per source) for your sample. Note the
rest-frame parameterization: T is the INTRINSIC dust temperature,
lambda0 the rest-frame opacity pivot; fnorm stays the observed flux at
observed 500 um.
"""

from mbb_emcee_tpu_torch import cmb_corrected_mbb

Z = 5.0

MODEL = cmb_corrected_mbb(Z, opthin=True, noalpha=True,
                          name=f"cmb-mbb-z{Z:g}")
