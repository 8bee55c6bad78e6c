"""Shared parameter-space configuration surface.

Torch-package twin of mbb_emcee_tpu/paramspace.py (the reference's
set_lowlim / set_uplim / fix_param / set_gaussian_prior setters). Host
classes provide `self._spec` (LikelihoodSpec), `self._init`,
`self._scatter`, `self._user_init`, `self._user_scatter` and `self.shape`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mbb_emcee_tpu_torch.likelihood import LikelihoodSpec, param_index


def _replace(spec: LikelihoodSpec, **kw) -> LikelihoodSpec:
    return dataclasses.replace(spec, **kw)


class ParamSpaceMixin:
    def _param_index(self, param):
        """Index of a parameter name or index (the MBB parameters; the
        population tier addresses its hyper-parameters instead)."""
        return param_index(param)

    def set_lowlim(self, param, value):
        """Hard lower box limit."""
        i = self._param_index(param)
        lo = self._spec.lower.copy()
        lo[i] = float(value)
        self._spec = _replace(self._spec, lower=lo)
        return self

    def set_uplim(self, param, value):
        i = self._param_index(param)
        hi = self._spec.upper.copy()
        hi[i] = float(value)
        self._spec = _replace(self._spec, upper=hi)
        return self

    def fix_param(self, param, value=None):
        """Fix a parameter (at `value`, or its current initial value); it
        is removed from the sampling space."""
        i = self._param_index(param)
        fixed = self._spec.fixed.copy()
        fv = self._spec.fixed_values.copy()
        fixed[i] = True
        fv[i] = float(value) if value is not None else float(self._init[i])
        self._spec = _replace(self._spec, fixed=fixed, fixed_values=fv)
        return self

    def unfix_param(self, param):
        i = self._param_index(param)
        fixed = self._spec.fixed.copy()
        fixed[i] = False
        self._spec = _replace(self._spec, fixed=fixed)
        return self

    def set_gaussian_prior(self, param, mean, sigma):
        if np.ndim(mean) != 0 or np.ndim(sigma) != 0:
            raise TypeError("set_gaussian_prior takes scalar mean/sigma")
        i = self._param_index(param)
        if not np.isfinite(mean):
            raise ValueError(f"prior mean must be finite; got {mean!r}")
        # NOT `sigma <= 0`: NaN compares False and would make every
        # lnprob NaN
        if not (np.isfinite(sigma) and sigma > 0):
            raise ValueError(
                f"prior sigma must be positive and finite; got {sigma!r}")
        pm = self._spec.prior_mean.copy()
        ps = self._spec.prior_isigma.copy()
        pm[i] = float(mean)
        ps[i] = 1.0 / float(sigma)
        self._spec = _replace(self._spec, prior_mean=pm, prior_isigma=ps)
        return self

    def set_param_init(self, param, value=None, scatter=None):
        """Set a parameter's initial walker-ball center and/or scatter;
        value=None keeps the data-driven T/fnorm auto-seed active."""
        i = self._param_index(param)
        if value is not None:
            self._init[i] = float(value)
            self._user_init[i] = True
        if scatter is not None:
            self._scatter[i] = float(scatter)
            self._user_scatter[i] = True
        return self

    @property
    def spec(self) -> LikelihoodSpec:
        return self._effective_spec()

    def _effective_spec(self) -> LikelihoodSpec:
        """Apply the model-shape implied fixing: opthin drops lambda0,
        noalpha drops alpha."""
        spec = self._spec
        fixed = spec.fixed.copy()
        fv = spec.fixed_values.copy()
        if self.shape.opthin and not fixed[2]:
            fixed[2] = True
            fv[2] = self._init[2]
        if self.shape.noalpha and not fixed[3]:
            fixed[3] = True
            fv[3] = self._init[3]
        return _replace(spec, fixed=fixed, fixed_values=fv)
