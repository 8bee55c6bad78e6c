"""Physics models: the greybody SED and the cosmology needed for derived
posteriors (luminosity distance)."""

from mbb_emcee_tpu_torch.models.modified_blackbody import (
    mbb_fnu, log_mbb_fnu, merge_log_x, ModifiedBlackbody, MBBShape,
)
from mbb_emcee_tpu_torch.models.cosmology import (
    Cosmology, luminosity_distance)
from mbb_emcee_tpu_torch.models.cmb import (
    cmb_corrected_mbb, dust_temperature_with_cmb, cmb_temperature,
    log_cmb_visibility, T_CMB0,
)

__all__ = [
    "mbb_fnu", "log_mbb_fnu", "merge_log_x", "ModifiedBlackbody", "MBBShape",
    "Cosmology", "luminosity_distance",
    "cmb_corrected_mbb", "dust_temperature_with_cmb", "cmb_temperature",
    "log_cmb_visibility", "T_CMB0",
]
