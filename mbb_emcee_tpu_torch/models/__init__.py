"""Physics models: the greybody SED and the cosmology needed for derived
posteriors (luminosity distance)."""
