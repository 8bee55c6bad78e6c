"""Physical constants (SI-derived, in the unit system used throughout).

Wavelengths are micron, fluxes are mJy unless stated otherwise. These mirror
the constants the reference package pulls from numpy/scipy/astropy
(ref: mbb_emcee/modified_blackbody.py uses h*c/k in micron*K [reconstructed,
see SURVEY.md provenance note]).
"""

# Second radiation constant h*c/k_B in micron * Kelvin.
HCOK_UM_K = 14387.768775039337

# Speed of light in micron * Hz (c = 2.99792458e8 m/s = 2.99792458e14 um/s).
C_UM_HZ = 2.99792458e14

# Speed of light, km/s (for cosmology).
C_KM_S = 299792.458

# Planck constant [J s] and Boltzmann constant [J/K].
H_JS = 6.62607015e-34
KB_JK = 1.380649e-23

# 1 Mpc in metres.
MPC_M = 3.0856775814913673e22

# Solar luminosity [W] (IAU 2015 nominal).
LSUN_W = 3.828e26

# Solar mass [kg].
MSUN_KG = 1.98892e30

# 1 Jansky in W / m^2 / Hz; photometry is in mJy.
JY_WM2HZ = 1e-26
MJY_WM2HZ = 1e-29

# Parameter order of the full modified-blackbody parameter vector.
# (ref: mbb_emcee mbb_fit.py parameter list (T/(1+z), beta, lambda0*(1+z),
#  alpha, fnorm) -- observer-frame T and lambda0 [reconstructed]).
PARAM_NAMES = ("T", "beta", "lambda0", "alpha", "fnorm")
NPARAMS = 5
