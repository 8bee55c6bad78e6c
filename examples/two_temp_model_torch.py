"""A ready-to-serve model file for `run_sed_tpu_torch` (the torch twin of
examples/two_temp_model.py).

    run_sed_tpu_torch examples/two_temp_model_torch.py catalog.txt out.h5 \\
        -w 128 -b 200 -n 600 --prior beta 1.8 0.4 \\
        --initval T_cold 18 --initval T_warm 45 \\
        --get-lir --ppc --summary --device cuda

(`--device cpu` runs the same fit on the CPU.)

Defines the canonical custom model -- a two-temperature greybody (cold
+ warm dust component, shared emissivity beta; cf. Dunne & Eales 2001)
-- as a module-level `MODEL`. Any single-theta torch `fnu(theta, wave)`
works the same way; see `mbb_emcee_tpu_torch.sed.SEDModel` for the
contract (wave of any shape in observed-frame um, f_nu out in mJy, plain
torch ops: it is batched with torch.func.vmap and differentiated by
torch.autograd).
"""

import torch

from mbb_emcee_tpu_torch import SEDModel, log_mbb_fnu
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape

_SHAPE = MBBShape(opthin=True, noalpha=True)


def two_temp_fnu(theta, wave):
    """Cold + warm greybody, shared beta.

    theta = (T_cold, T_warm, beta, fnorm_cold, fnorm_warm); each
    component reuses the validated single-MBB primitive (lambda0/alpha
    slots are inert under opthin+noalpha)."""
    t_c, t_w, beta, f_c, f_w = theta
    pin = [torch.full_like(t_c, 250.0), torch.full_like(t_c, 4.0)]
    p_c = torch.stack([t_c, beta, *pin, f_c])
    p_w = torch.stack([t_w, beta, *pin, f_w])
    return (torch.exp(log_mbb_fnu(p_c, wave, _SHAPE))
            + torch.exp(log_mbb_fnu(p_w, wave, _SHAPE)))


# Disjoint temperature ranges break the component-swap symmetry (the
# cheap way; run_sed_tpu_torch --pt handles genuinely multimodal cases).
MODEL = SEDModel(
    fnu=two_temp_fnu,
    param_names=("T_cold", "T_warm", "beta", "fnorm_cold", "fnorm_warm"),
    lower=[5.0, 25.0, 0.5, 1e-3, 1e-4],
    upper=[25.0, 120.0, 4.0, 1e3, 1e2],
    name="two-temp-greybody")
