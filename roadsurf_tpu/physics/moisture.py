"""Moisture utilities: Magnus saturation pressure, Tdew <-> RH.

Re-derivation of src/InputOutput.f90:202-268 and
examples/example1/src/MeteorologyTools.cpp (Magnus formula over water / ice).

Array-namespace generic: jax inputs (incl. tracers) compute with jnp, plain
numpy/python inputs with numpy.  The numpy path matters operationally -- the
ingest data plane (JsonSource Tdew/RH completion, grid-source extraction)
calls these on host arrays, and a jnp-only implementation would send every
ingest op through the device.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

AFACT = 0.61078   # kPa
ALPHA_ICE = 21.875
BETA_ICE = 265.5
ALPHA_WAT = 17.269
BETA_WAT = 237.3


def _ns(*xs):
    """numpy for host arrays, jnp for jax arrays/tracers."""
    return (jnp if any(isinstance(x, jax.Array) for x in xs) else np)


def esat(t):
    """Saturation vapor pressure (kPa), over ice below 0 C, water above
    (src/BoundaryLayer.f90:159-171)."""
    xp = _ns(t)
    t = xp.asarray(t)
    e_ice = AFACT * xp.exp(ALPHA_ICE * t / (t + BETA_ICE))
    e_wat = AFACT * xp.exp(ALPHA_WAT * t / (t + BETA_WAT))
    return xp.where(t < 0.0, e_ice, e_wat)


def esat_air_convention(t):
    """Same as :func:`esat` but with the >= 0 branch on water, matching
    CalcRh/CalcTDew (src/InputOutput.f90:223-229: T >= 0 -> water)."""
    xp = _ns(t)
    t = xp.asarray(t)
    e_ice = AFACT * xp.exp(ALPHA_ICE * t / (t + BETA_ICE))
    e_wat = AFACT * xp.exp(ALPHA_WAT * t / (t + BETA_WAT))
    return xp.where(t >= 0.0, e_wat, e_ice)


def rh_from_tdew(t2m, tdew):
    """RH (%) from air and dew point temperature (src/InputOutput.f90:202-236)."""
    xp = _ns(t2m, tdew)
    rh = (esat_air_convention(tdew) / esat_air_convention(t2m)) * 100.0
    return xp.minimum(rh, 100.0)


def tdew_from_rh(t2m, rhz):
    """Dew point (C) from air temperature and RH (src/InputOutput.f90:239-268).

    Note the reference chooses the alpha/beta pair from T2m (not from the
    resulting dew point) -- replicated here.
    """
    xp = _ns(t2m, rhz)
    t2m = xp.asarray(t2m)
    alpha = xp.where(t2m >= 0.0, ALPHA_WAT, ALPHA_ICE)
    beta = xp.where(t2m >= 0.0, BETA_WAT, BETA_ICE)
    epr_sat = AFACT * xp.exp(alpha * t2m / (t2m + beta))
    epr = 0.01 * xp.asarray(rhz) * epr_sat
    with np.errstate(divide="ignore", invalid="ignore"):
        xx = xp.log(epr / AFACT)
        return beta * xx / (alpha - xx)
