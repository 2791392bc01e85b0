"""Net radiation and sky-view / local-horizon radiation modification.

Re-derivation of CalcRNet (src/BalanceModel.f90:282-307) and
ModRadiationBySurroundings (src/ModRadiation.f90:7-73, after Senkova et al.
2007).  The sky-view modification is a pure function of (time, location,
forcing), so it runs as one vectorized [P?, T] pass during forcing prep.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import PhysicsParams


def net_radiation(tsurf, albedo, sw, lw, sw_cof, lw_cof, p: PhysicsParams):
    """RNet = (1-albedo)*SW*SwCof + emiss*LW*LwCof - emiss*sigma*T_K^4
    (src/BalanceModel.f90:282-307)."""
    tk = tsurf + 273.15
    tk2 = tk * tk
    rbb = p.emiss * p.sb_const * (tk2 * tk2)
    return (1.0 - albedo) * sw * sw_cof + p.emiss * lw * lw_cof - rbb


def modify_radiation(sw, sw_dir, lw, lw_net, elev, azim, sky_view,
                     horizons, p: PhysicsParams, flat_horizons: bool = False,
                     pexp=None):
    """Sky-view/horizon correction of the radiation forcing
    (src/ModRadiation.f90:7-73).

    sw/sw_dir/lw/lw_net/elev/azim: any shared layout (elev/azim from
    sun.elevation_azimuth); sky_view broadcastable against them;
    horizons: [*point_dims, 360] local horizon angles (degrees per azimuth
    degree); ``pexp`` maps a point-shaped array (a horizon degree column)
    to something broadcastable against elev -- default ``x[..., None]``,
    i.e. point dims leading and time LAST; the tile-major forcing prep
    passes its own (time axis in the middle).  flat_horizons:
    statically-known all-zero horizons (sky-view factor only, the common
    operational case) skip the lookup entirely.

    Returns (sw_mod, lw_mod).  The caller applies this only where
    0 <= sky_view < 1, matching the driver guard
    (examples/example1/src/Simulation.f90:152-155).
    """
    if pexp is None:
        pexp = lambda x: x[..., None]
    dif_sw = sw - sw_dir
    lw_surroundings = lw_net - lw

    # nearest-degree horizon lookup (ModRadiation.f90:40-45); the reference
    # reads out-of-bounds when the sun is below the horizon (azimuth sentinel
    # -9999.9) but the result is unused then -- we clamp the index instead.
    if flat_horizons:
        horizon = jnp.zeros_like(elev)
    else:
        azim_idx = jnp.clip(jnp.round(azim).astype(jnp.int32) % 360, 0, 359)
        if horizons.ndim > 1:
            # per-point tables: a 360-way select sweep (instead of a
            # take_along_axis over the minor 360-axis) picks the identical
            # value -- exactly one degree matches per element
            horizon = jnp.zeros_like(elev)
            for d in range(360):
                horizon = jnp.where(azim_idx == d, pexp(horizons[..., d]),
                                    horizon)
        else:
            horizon = horizons[azim_idx]

    shadow = jnp.where(horizon > elev, 0.0, 1.0)
    sun_up = elev > 0.0

    sw_dir_m = jnp.where(sun_up, sw_dir * shadow, sw_dir)
    sw_ref = p.albedo_surroundings * sw_dir_m + p.albedo_surroundings * dif_sw
    dif_m = sky_view * dif_sw + (1.0 - sky_view) * sw_ref
    sw_m = jnp.where(sun_up, dif_m + sw_dir_m, sw)

    lw_m = sky_view * lw + (1.0 - sky_view) * (-lw_surroundings)
    return sw_m, lw_m
