"""Fused whole-scan kernel: the forecast time loop of a block of road points
in one Pallas program (Triton route).

The plain XLA path (``model.scan_steps``: step.py under ``lax.scan``) moves
~120 B of prognostic state per point through device memory every step, and
its boundary-layer ``lax.while_loop`` splits each step into several kernels
with a device-to-host predicate read per iteration.  This kernel instead:

 * grid = (tile, block of points in the tile); each program owns ``block``
   consecutive points for the whole call;
 * carries every state row -- the L+2 temperature-profile rows and the 13
   scalar rows -- as its own [block] vector in the time loop's carry, so the
   state stays in registers from the first step to the last;
 * loads each step's forcing rows straight from device memory, ``block``
   contiguous floats per channel (the only per-step traffic: 44 B per
   point-step in the slim layout);
 * stores output rows only at the output cadence, under ``pl.when``.

Forcing comes in three layouts that differ only in strides: point-major
[T, NCH, P] (the generic/gather paths), tile-major [n_tiles, T, NCH, subl,
LANE] (the fused station->point expansion) and SLIM tile-major [n_tiles, T,
NCH_SLIM, subl, LANE], where only the genuinely (station, step)-varying
channels ride device memory: TRF is time-only (one scalar load per step), the
radiation cofs are computed in kernel from aux rows when coupled, and the
coupling obs is an aux row.  ``pallas_scan`` views all three as
[n_tiles, T, nch, tile_p] (point-major is one tile of P points).

The physics replicates the same branch-free re-derivation as
roadsurf_tpu.physics / step.py (reference citations there); the
boundary-layer fixed point uses masked-freeze iterations, identical to the
scan path's early-exit while_loop.  Every expression keeps the reference's
operand order, and where XLA's algebraic simplifier rewrites the reference
(a divide by a constant into a product by its reciprocal, a chain of
constant factors into one, ``(a / b) / c`` into ``a / (b * c)``) the kernel
writes the rewritten form itself, because Triton compiles the source as
written: the compiled kernel then equals the XLA scan on the GPU bit for
bit (chip_smoke.py phase c).  Parity vs the scan path is tested in
tests/test_pallas_step.py; the fused/slim layouts are bitwise vs the gather
path in tests/test_production_fused.py.

The coupled production driver streams phases A/C through this kernel (the
in-window phase B runs the iteration-major engine in coupling.py); the
post-coupling radiation-coefficient decay runs in kernel under have_cofs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import PhysicsParams
from ..grid import LayerGrid
from ..physics.boundary_layer import CONV_LIM, MIN_ITER
from ..step import StepConfig

# ---- row indices into the packed scalar state [NROWS, P] -----------------
R_TSURF, R_WAT, R_SNOW, R_ICE, R_ICE2, R_DEP = 0, 1, 2, 3, 4, 5
R_Q2MELT, R_T4MELT, R_EVAP, R_BLCOND, R_ALBEDO = 6, 7, 8, 9, 10
R_VERYCOLD, R_FAILED = 11, 12          # 0.0 / 1.0 flags
NROWS = 13

# ---- forcing channel indices (axis 1 of [T, NCH, P]) ----------------------
# C_EAIR and C_AIRVCAP are pure functions of the raw forcing (tair, rhz),
# precomputed once in pack_forcing: this removes one exp (Magnus esat(tair))
# and one divide (air density) from every timestep of the hot loop.
C_TAIR, C_VZ, C_EAIR, C_RAIN, C_SNOW, C_SW, C_LW = 0, 1, 2, 3, 4, 5, 6
C_TSURF_OBS, C_VALID, C_TRF, C_SWCOF, C_LWCOF, C_INCPL, C_CPLOBS = \
    7, 8, 9, 10, 11, 12, 13
C_AIRVCAP = 14
NCH = 15

# SLIM forcing layout (the fused tile-major path): only the channels that
# genuinely vary per (station, step) ride the [n_tiles, T, nch, subl, LANE]
# tensor -- TRF is time-only (a [T] side channel), SWCOF/LWCOF are 1 outside
# coupling (computed in kernel from aux rows when coupled), CPLOBS is a
# per-point constant (aux row 3).
SLIM_CHANNELS = (C_TAIR, C_VZ, C_EAIR, C_RAIN, C_SNOW, C_SW, C_LW,
                 C_TSURF_OBS, C_VALID, C_INCPL, C_AIRVCAP)
NCH_SLIM = len(SLIM_CHANNELS)
_SLIM_POS = {c: i for i, c in enumerate(SLIM_CHANNELS)}

#: output rows, in order: tsurf, wat, snow, ice, ice2, dep
OUT_ROWS = (R_TSURF, R_WAT, R_SNOW, R_ICE, R_ICE2, R_DEP)
N_OUT_FIELDS = len(OUT_ROWS)

# Point geometry.  LANE is the point quantum: every per-device point count
# is a multiple of it, so the kernel block (a power of two dividing LANE)
# always divides it.  The fused station->point expansion works on tiles of
# TILE_P = SUBL * LANE points laid out [subl, LANE] (one one-hot block per
# tile, production.StationExpander); the kernel's blocks subdivide a tile.
LANE = 128
SUBL = 64
TILE_P = SUBL * LANE

# Points per program, one point per thread (BLOCK // 32 warps): the state
# carry is ~30 live [BLOCK] vectors, so one point per thread keeps it in
# registers with room for the step's temporaries.  One warp (32 points)
# measured fastest of 32/64/128/256 on an H100 (PERF.md): a program leaves
# the boundary-layer loop as soon as its own 32 points have converged.
# bench.py sweeps other values by rebinding this constant.
BLOCK = 32


def _recip(c):
    """XLA's algebraic simplifier turns ``x / c`` into ``x * (1 / c)``, the
    reciprocal rounded to float32.  The kernel writes that form itself
    wherever the reference divides by a constant."""
    return np.float32(1) / np.float32(c)


def _fold(*factors):
    """A chain of constant factors folded as XLA folds ``(x * a) * b`` into
    ``x * (a * b)``: float32, rounded after each product."""
    out = np.float32(factors[0])
    for f in factors[1:]:
        out = np.float32(out * np.float32(f))
    return out


def _esat(t):
    # Magnus over ice/water -- coefficients selected per lane so only ONE
    # transcendental is evaluated (vs exp-both-and-select); same value
    # (BoundaryLayer.f90:156-170)
    a = jnp.where(t < 0.0, 21.875, 17.269)
    b = jnp.where(t < 0.0, 265.5, 237.3)
    return 0.61078 * jnp.exp(a * t / (t + b))


def _bl_fixed_point(blcond, tsurf, tair, vz, air_vcap, p: PhysicsParams,
                    n_iter: int):
    """Masked-freeze boundary-layer iteration (BoundaryLayer.f90:60-101):
    identical results to the early-exit loop (frozen lanes stop changing).

    Every expression has the operand order of
    physics.boundary_layer.bl_conductance, so the kernel rounds as the XLA
    reference does.  No point can converge before iteration MIN_ITER, so
    those iterations run without a check; after them the program leaves the
    loop as soon as every point of its block has converged."""
    tak = tair + 273.15
    dt_ts = tsurf - tair
    k_vz = p.vk_const * vz                       # loop invariants
    k_vcap = air_vcap * p.vk_const
    vcap_tak = air_vcap * tak
    stab_c = -p.vk_const * p.zref_t * p.grav

    def body(j, carry):
        bl, psim, psih, done = carry
        ustar = k_vz / (p.log_ustar + psim)
        bl_new = k_vcap * ustar / (p.log_cond + psih)
        stab = (stab_c * bl_new * dt_ts
                / (vcap_tak * ustar * ustar * ustar))
        stab = jnp.minimum(stab, 1.0)
        psih_s = 4.7 * stab
        psih_u = -2.0 * jnp.log(
            (1.0 + jnp.sqrt(jnp.maximum(1.0 - 16.0 * stab, 0.0))) / 2.0)
        stable = stab > 0.0
        psih_n = jnp.where(stable, psih_s, psih_u)
        psim_n = jnp.where(stable, psih_n, 0.6 * psih_n)
        newly = (jnp.abs(bl_new - bl) < CONV_LIM) & (j + 1 >= MIN_ITER)
        bl = jnp.where(done, bl, bl_new)
        psim = jnp.where(done, psim, psim_n)
        psih = jnp.where(done, psih, psih_n)
        return bl, psim, psih, done | newly

    zero = jnp.zeros_like(blcond)
    carry = (blcond, zero, zero, zero > 1.0)
    for j in range(min(MIN_ITER, n_iter)):
        carry = body(j, carry)

    def w_cond(c):
        return (c[0] < n_iter) & (jnp.min(c[4].astype(jnp.int32)) == 0)

    def w_body(c):
        return (c[0] + 1,) + body(c[0], c[1:])

    carry = jax.lax.while_loop(w_cond, w_body,
                               (np.int32(min(MIN_ITER, n_iter)),) + carry)
    return carry[1], carry[2], carry[3]


def _stencil(tmp, bl, rnet, le, trf, dt, p, dyc, cond_dz, wcont, nlayers):
    """CalcHCapHCond + calcProfile + calcHStor, unrolled over layers
    (BalanceModel.f90:90-129, :189-251, :311-322); tmp: tuple of L+2
    profile rows."""
    sens = bl * (tmp[0] - tmp[1])
    g_prev = rnet - le + trf + sens
    hs1 = None
    updates = []
    for j in range(1, nlayers + 1):
        t = tmp[j]
        t2_ = t * t
        roo = jnp.where(t < 0.0, 920.0,
                        -0.0050 * t2_ + 0.0079 * t + 1000.0028)
        cw = jnp.where(t < 0.0, 2100.0,
                       0.0000102 * t2_ * t2_ - 0.0017169 * t2_ * t
                       + 0.11516 * t2_ - 3.4739 * t + 4217.2)
        chwt = roo * cw
        if j <= 2:
            vsh = (1.0 - p.poro1) * p.vsh1 + wcont[j - 1] * chwt
        else:
            vsh = (1.0 - p.poro2) * p.vsh2 + wcont[j - 1] * chwt
        if j == 1:
            hs1 = vsh * dyc[0] * _recip(dt)
        cap_dz = -1.0 / (dyc[j - 1] * vsh)
        gflux = cond_dz[j - 1] * (tmp[j + 1] - tmp[j])
        updates.append(tmp[j] + dt * cap_dz * (gflux - g_prev))
        g_prev = gflux
    t1a = (tmp[1] + 3.0 * tmp[2]) / 4.0
    new_tmp = (tmp[0],) + tuple(updates) + tuple(tmp[nlayers + 1:])
    tna = (new_tmp[1] + 3.0 * new_tmp[2]) / 4.0
    hstor = hs1 * (tna - t1a)
    return new_tmp, hs1, hstor


def _surf_ave(tmp, cfg: StepConfig):
    if cfg.use_depth:
        i = cfg.depth_idx
        return tmp[i] + cfg.depth_w * (tmp[i + 1] - tmp[i])
    return (tmp[1] + tmp[2]) / 2.0


def _melting(tmp_new, tsurf, snow, ice, ice2, q2, t4, hstor, hs1,
             in_cpl, last_obs, cfg, p):
    """Storage.f90:319-402 on row layout."""
    has_frozen = (snow > 0.0) | (ice > 0.0) | (ice2 > 0.0)
    q2_out = jnp.where(has_frozen, q2, 0.0)
    if not cfg.melting_can_change_temperature:
        return tmp_new, q2_out
    guard = ((hstor <= 0.00001) | (tsurf <= t4) | (q2 <= 0.0)
             | (in_cpl & (last_obs < t4)))
    cold = guard & (tsurf < 0.5)
    hot = guard & (tsurf > 2.0)
    qavail = hs1 * (tmp_new[1] - t4)
    pin = has_frozen & (~cold) & (~hot)
    all_used = q2 >= qavail
    t1p = jnp.where(all_used, t4 + 0.01, t4 + (qavail - q2) / hs1)
    t2p = t4 + 0.01
    tmp_out = ((tmp_new[0], jnp.where(pin, t1p, tmp_new[1]),
                jnp.where(pin, t2p, tmp_new[2])) + tuple(tmp_new[3:]))
    q2_out = jnp.where(has_frozen & cold, 0.0, q2_out)
    q2_out = jnp.where(has_frozen & hot, jnp.minimum(q2_out, qavail), q2_out)
    q2_out = jnp.where(pin & all_used, qavail, q2_out)
    return tmp_out, q2_out


def _road_cond(wat, snow, ice, ice2, dep, tsurf, evap, q2, t4, vcold,
               cfg: StepConfig, p: PhysicsParams):
    """WearFactors + RoadCond + CalcAlbedo (src/Cond.f90, src/Storage.f90)."""
    tph, dt = cfg.tph, cfg.dt
    vcold = vcold & ~(vcold & (tsurf > p.t_lim_cold_h))
    vcold = vcold | ((~vcold) & (tsurf < p.t_lim_cold_l))

    # constant factors folded as XLA folds them in storage.py's expressions
    snow_tran = jnp.maximum((0.2 + 0.25) * snow, 0.01)
    snow_tran = jnp.where(snow < 0.2, snow_tran * 3.0, snow_tran)
    snow_to_ice = snow_tran * _fold(0.25 / (0.2 + 0.25), tph)
    snow_tran = snow_tran * tph
    ice_wear = jnp.maximum(1.1 * 2.0 * 0.145 * ice, 0.01) * tph
    ice_wear2 = jnp.maximum(1.1 * 2.0 * (4.0 * 0.290) * ice2, 0.01) * tph
    dep_wear = jnp.maximum(0.5 * 2.0 * (4.0 * 0.290) * dep, 0.01) * tph
    wat_wear = jnp.maximum(0.145 * wat, 0.06) * _fold(10.0, tph)
    heat = p.wat_m_heat * p.wat_dens

    bare = (snow <= 0.0) & (ice <= 0.0) & (dep <= 0.0) & (tsurf > p.t_lim_dew)
    loss = jnp.where(wat > p.max_por_mms, evap, p.por_eva_f * evap)
    wat = jnp.where(bare, wat - loss, wat)
    wearing = wat > 0.0
    ww = jnp.where(wat < p.w_wear_lim, 0.0, wat_wear)
    amt = jnp.where(wat > p.w_wet_lim, ww, p.damp_wear_f * ww)
    wat = jnp.where(wearing, wat - amt, wat)
    wat = jnp.where(wat < p.min_wat_mms, 0.0, wat)
    wat = jnp.minimum(wat, p.max_wat_mms)
    srf_ext = jnp.maximum(wat - p.max_por_mms, 0.0)

    rd = srf_ext + snow
    wsr = jnp.where(rd > 0.001, srf_ext / rd, 0.0)
    snow_wet = (snow > 0.0) & (wsr > p.wet_snow_form_r)
    under = snow > 0.0
    ice = jnp.where(under, ice + dep, ice)
    dep = jnp.where(under, 0.0, dep)
    has_snow = snow > 0.0
    melt_f = has_snow & bool(cfg.force_snow_melting)
    melts = has_snow & (~melt_f) & (q2 > 0.0) & (tsurf >= p.t_lim_melt_snow)
    mm = q2 * _fold(_fold(1000.0, dt), _recip(heat))
    wat = jnp.where(melt_f, wat + snow, jnp.where(melts, wat + mm, wat))
    snow = jnp.where(melt_f, 0.0, jnp.where(melts, snow - mm, snow))
    wearing = snow > 0.0
    snow = jnp.where(wearing, snow - snow_tran, snow)
    ice = jnp.where(wearing, ice + snow_to_ice, ice)
    ice2 = jnp.where(wearing, ice2 + snow_to_ice, ice2)
    wet_block = (snow > 0.0) & snow_wet
    melting_wet = wet_block & (wsr > p.wet_snow_melt_r)
    wat = jnp.where(melting_wet, wat + snow, wat)
    snow = jnp.where(melting_wet, 0.0, snow)
    freezing = wet_block & (tsurf < p.t_lim_freeze)
    amt2 = snow + wat
    ice = jnp.where(freezing, ice + amt2, ice)
    ice2 = jnp.where(freezing, ice2 + amt2, ice2)
    snow = jnp.where(freezing, 0.0, snow)
    wat = jnp.where(freezing, 0.0, wat)
    snow = jnp.where(snow < p.min_snow_mms, 0.0, snow)
    snow = jnp.where(snow > p.max_snow_mms, snow - p.max_snow_mms / 2.0, snow)

    freezing = (tsurf < p.t_lim_freeze) & (wat > 0.0)
    ice = jnp.where(freezing, ice + wat, ice)
    ice2 = jnp.where(freezing, ice2 + wat, ice2)
    wat = jnp.where(freezing, 0.0, wat)
    meltable = (snow <= 0.0) & (ice > 0.0)
    melt_f = meltable & bool(cfg.force_ice_melting)
    melts = meltable & (~melt_f) & (q2 > 0.0) & (tsurf >= p.t_lim_melt_ice)
    wat = jnp.where(melt_f, wat + ice, jnp.where(melts, wat + mm, wat))
    ice_n = jnp.where(melt_f, 0.0, jnp.where(melts, ice - mm, ice))
    ice2 = jnp.where(melt_f, 0.0, jnp.where(melts, ice2 - mm, ice2))
    ice = ice_n
    ice = jnp.where(ice > 0.0, ice - ice_wear, ice)
    ice2 = jnp.where(ice2 > 0.0, ice2 - ice_wear2, ice2)
    ice = jnp.where(ice < p.min_ice_mms, 0.0, ice)
    ice = jnp.minimum(ice, p.max_ice_mms)
    ice2 = jnp.where(ice2 < p.min_ice_mms, 0.0, ice2)
    ice2 = jnp.minimum(ice2, p.max_ice_mms)

    dep = jnp.where(evap < 0.0, dep - evap, dep)
    melting = tsurf > p.t_lim_melt_dep
    wat = jnp.where(melting, wat + dep, wat)
    dep = jnp.where(melting, 0.0, dep)
    wearing = (snow <= 0.0) & (dep > 0.0)
    dep = jnp.where(wearing, dep - dep_wear, dep)
    dep = jnp.where(dep < p.min_dep_mms, 0.0, dep)
    over = dep > p.max_dep_mms
    wat = jnp.where(over, wat + dep - p.max_dep_mms, wat)
    dep = jnp.minimum(dep, p.max_dep_mms)

    wat = jnp.where(wat < p.min_wat_mms, 0.0, wat)
    wat = jnp.minimum(wat, p.max_wat_mms)

    q2n = jnp.zeros_like(wat)
    melt_heat = _fold(_fold(heat, _recip(1000.0)), _recip(dt))
    snowy = snow > 0.0
    q2n = jnp.where(snowy, snow * melt_heat, q2n)
    t4n = jnp.where(snowy, p.t_lim_melt_snow, t4)
    icy = (~snowy) & (ice > 0.0)
    q2n = jnp.where(icy, ice * melt_heat, q2n)
    t4n = jnp.where(icy, p.t_lim_melt_ice, t4n)
    q2n = jnp.maximum(q2n, 0.0)

    ice_sum = jnp.maximum(0.5 * (ice + ice2) + dep, 0.0)
    snowy_a = (snow > 0.01) & (snow > ice)
    icy_a = (ice > 0.01) | (dep > 0.01)
    icy_alb = jnp.where(
        ice_sum < 1.5,
        p.alb_dry + ice_sum * _fold(_recip(1.5), p.alb_snow - p.alb_dry),
        p.alb_snow)
    albedo = jnp.full_like(wat, p.alb_dry)
    albedo = jnp.where(snowy_a, p.alb_snow,
                       jnp.where(icy_a & ~snowy_a, icy_alb, albedo))
    return wat, snow, ice, ice2, dep, vcold, q2n, t4n, albedo




def _make_kernel(nsteps, out_stride, cfg, p, dyc, cond_dz, wcont, bl_iters,
                 lpad, tile_p, block, slim=False, have_cofs=False,
                 t_total=None, cof_red=None):
    nlayers = len(dyc)
    l2 = nlayers + 2
    dt = cfg.dt
    os32 = np.int32(out_stride)

    def kernel(off_ref, *refs):
        if slim:
            # aux_ref [4, P]: sw_corr, lw_corr, coupling_end, coupling obs;
            # trf_ref [T_pad]: time-only traffic friction
            (trf_ref, forc_ref, tmp_ref, scal_ref, aux_ref,
             out_ref, tmp_out, scal_out) = refs
        else:
            forc_ref, tmp_ref, scal_ref, out_ref, tmp_out, scal_out = refs
        tile = pl.program_id(0)
        b0 = pl.program_id(1) * block             # offset within the tile
        pts = pl.ds(tile * tile_p + b0, block)    # this program's points
        # global step offset of this call (the production engine streams the
        # scan in time chunks; output rows index the GLOBAL output stride so
        # each chunk emits only the rows the run actually keeps)
        off = off_ref[0]
        out_base = jax.lax.div(off + os32 - np.int32(1), os32)
        if slim:
            aux = [aux_ref[k, pts] for k in range(4)]

        def fc(t, c):
            ch = _SLIM_POS[c] if slim else c
            return forc_ref[tile, t, ch, pl.ds(b0, block)]

        def step_body(t, carry):
            tmp, sc = carry
            tg = t + off
            tair = fc(t, C_TAIR)
            failed_prev = sc[R_FAILED]
            tsurf = sc[R_TSURF]
            abnormal = (tsurf < -100.0) | (tsurf > 100.0)
            failed = failed_prev | (fc(t, C_VALID) < 0.5) | abnormal
            active = ~failed_prev

            # SetCurrentValues + obs forcing
            obs = fc(t, C_TSURF_OBS)
            force_obs = obs > -100.0
            tmp = ((tair, jnp.where(force_obs, obs, tmp[1]),
                    jnp.where(force_obs, obs, tmp[2])) + tuple(tmp[3:]))
            tsurf = jnp.where(force_obs, _surf_ave(tmp, cfg), tsurf)

            # precipitation to storage
            wat = sc[R_WAT] + fc(t, C_RAIN)
            snow = sc[R_SNOW] + fc(t, C_SNOW)
            ice, ice2, dep = sc[R_ICE], sc[R_ICE2], sc[R_DEP]

            # boundary layer + latent heat
            vz = fc(t, C_VZ)
            air_vcap = fc(t, C_AIRVCAP)
            bl, psim, psih = _bl_fixed_point(
                sc[R_BLCOND], tsurf, tair, vz, air_vcap, p, bl_iters)
            raero = jnp.minimum(
                (p.log_mom + psim) * (p.log_heat + psih)
                / (p.vk_const * p.vk_const * vz), 30.0)
            tak = tair + 273.15
            psych_c = 0.1 * (0.00063 * tak + 0.47496)
            wat_den = (-0.0050 * tsurf * tsurf + 0.0079 * tsurf
                       + 1000.0028)
            esurf = _esat(tsurf)
            eair = fc(t, C_EAIR)
            le_num = air_vcap * (esurf - eair)
            le_den = psych_c * raero
            le = le_num / le_den
            lheat = jnp.where(tsurf >= 0.0, p.lvap, p.lfus)
            # XLA turns the reference's (le / (lheat*wat_den)) * 1000 * dt
            # into one divide and one folded factor
            evap = (le_num / (le_den * (lheat * wat_den))
                    * _fold(1000.0, dt))
            dry = (le > 0.0) & (wat <= 0.0)
            le = jnp.where(dry, 0.0, le)
            evap = jnp.where(dry, 0.0, evap)

            # net radiation; under have_cofs the post-coupling decayed
            # radiation coefficients are computed IN KERNEL from the
            # per-point correction/window rows (forcing.cof_window
            # semantics, src/Coupling.f90:82-88 + the lastValues reuse)
            # so the fused tile-major forcing needs no per-point channel
            if slim:
                # SWCOF/LWCOF do not ride the slim forcing: they are 1
                # outside coupling (and multiplying by the exact 1.0
                # reproduces the full-channel path bit for bit)
                sw_cof = jnp.float32(1.0)
                lw_cof = jnp.float32(1.0)
            else:
                sw_cof, lw_cof = fc(t, C_SWCOF), fc(t, C_LWCOF)
            if have_cofs:
                i = tg + np.int32(1)
                i_eff = i
                if t_total >= 2:
                    i_eff = jnp.where(tg == np.int32(t_total - 1), i - 1, i)
                cend_f = aux[2]
                i_eff_f = i_eff.astype(jnp.float32)
                dts = jnp.float32(dt)
                expo = (-(dts * i_eff_f - dts * cend_f)
                        / jnp.float32(cof_red))
                dec = jnp.exp(jnp.minimum(expo, jnp.float32(0.0)))
                on = ((i_eff_f >= cend_f)
                      & (cend_f >= jnp.float32(1.0)))
                sw_cof = sw_cof * jnp.where(
                    on, jnp.float32(1.0) + aux[0] * dec, jnp.float32(1.0))
                lw_cof = lw_cof * jnp.where(
                    on, jnp.float32(1.0) + aux[1] * dec, jnp.float32(1.0))
            # the coefficients scale the forcing BEFORE it meets albedo and
            # emissivity: a product by an exact 1.0 (slim: a constant the
            # compiler folds away) then leaves one expression shape for the
            # GPU compiler to contract into FMAs, so every layout rounds
            # alike
            tk = tsurf + 273.15
            tk2 = tk * tk
            rnet = ((1.0 - sc[R_ALBEDO]) * (fc(t, C_SW) * sw_cof)
                    + p.emiss * (fc(t, C_LW) * lw_cof)
                    - p.emiss * p.sb_const * (tk2 * tk2))

            # stencil
            trf = trf_ref[tg] if slim else fc(t, C_TRF)
            new_tmp, hs1, hstor = _stencil(
                tmp, bl, rnet, le, trf, dt, p, dyc, cond_dz, wcont, nlayers)

            # melting limiter
            q2, t4 = sc[R_Q2MELT], sc[R_T4MELT]
            in_cpl = fc(t, C_INCPL) > 0.5
            cplobs = aux[3] if slim else fc(t, C_CPLOBS)
            new_tmp, q2 = _melting(new_tmp, tsurf, snow, ice, ice2, q2, t4,
                                   hstor, hs1, in_cpl, cplobs, cfg, p)
            tsurf_new = _surf_ave(new_tmp, cfg)

            # storages
            (wat, snow, ice, ice2, dep, vcold, q2, t4, albedo) = \
                _road_cond(wat, snow, ice, ice2, dep, tsurf_new, evap,
                           q2, t4, sc[R_VERYCOLD], cfg, p)

            # commit (mask by active)
            sel = lambda n, o: jnp.where(active, n, o)
            tmp_new = tuple(sel(n, o) for n, o in zip(new_tmp, carry[0]))
            sc_new = (sel(tsurf_new, sc[R_TSURF]), sel(wat, sc[R_WAT]),
                      sel(snow, sc[R_SNOW]), sel(ice, sc[R_ICE]),
                      sel(ice2, sc[R_ICE2]), sel(dep, sc[R_DEP]),
                      sel(q2, sc[R_Q2MELT]), sel(t4, sc[R_T4MELT]),
                      sel(evap, sc[R_EVAP]), sel(bl, sc[R_BLCOND]),
                      sel(albedo, sc[R_ALBEDO]), sel(vcold, sc[R_VERYCOLD]),
                      failed)

            # output at the GLOBAL stride (the step failing CheckValues
            # still emits; later steps are poisoned -- step.py semantics)
            @pl.when(jax.lax.rem(tg, os32) == 0)
            def _():
                row = jax.lax.div(tg, os32) - out_base
                for k, r in enumerate(OUT_ROWS):
                    out_ref[row, k, pts] = jnp.where(failed_prev, -9999.0,
                                                     sc_new[r])
            return tmp_new, sc_new

        tmp0 = tuple(tmp_ref[j, pts] for j in range(l2))
        sc0 = tuple(scal_ref[r, pts] for r in range(NROWS))
        sc0 = (sc0[:R_VERYCOLD]
               + (sc0[R_VERYCOLD] > 0.5, sc0[R_FAILED] > 0.5))
        tmp, sc = jax.lax.fori_loop(np.int32(0), np.int32(nsteps), step_body,
                                    (tmp0, sc0))
        for j in range(lpad):
            tmp_out[j, pts] = tmp[j] if j < l2 else tmp_ref[j, pts]
        for r in range(NROWS):
            scal_out[r, pts] = (sc[r].astype(jnp.float32)
                                if r in (R_VERYCOLD, R_FAILED) else sc[r])

    return kernel


def pallas_scan(tmp0, scal0, forcing, cfg: StepConfig, p: PhysicsParams,
                grid: LayerGrid, out_stride: int = 1, bl_iters: int = 40,
                interpret: bool = False, nsteps: int = None,
                out_offset=None, n_out: int = None,
                t_total: int = None, cof_red: float = None,
                slim_trf=None, aux_rows=None, aux_cofs: bool = False):
    """Run the fused forecast scan.

    tmp0: [LPAD, P] float32 initial profile (row 0 air, rows 1..L ground,
    row L+1 climatology; LPAD >= L+2, rows past L+2 pass through);
    scal0: [NROWS, P] packed scalar state;
    forcing: [T, NCH, P] packed forcing channels, OR tile-major
    [n_tiles, T, NCH, subl, LANE] (the fused-expansion layout: each tile's
    forcing is contiguous; detected by ndim == 5).

    nsteps: steps to run, <= T (the production engine pads the final
    streaming chunk to its chunk length; rows >= nsteps are never read).

    aux_rows (with slim_trf, the SLIM tile-major mode): [4, P] float32
    (sw_corr, lw_corr, coupling_end, coupling_obs).  With
    ``aux_cofs=True`` the post-coupling radiation coefficients are
    computed in kernel per step (forcing.cof_window semantics; requires
    ``t_total`` -- the full run length for the lastValues reuse -- and
    ``cof_red`` = settings.coupling_effect_reduction) and MULTIPLY the
    forcing's SWCOF/LWCOF values (exactly 1 in slim mode).

    out_offset: GLOBAL step index of this call's first step (traced scalar
    ok).  Output rows are collected where (out_offset + t) %% out_stride == 0
    -- the production engine's chunks emit exactly the run-level output
    cadence regardless of chunk boundaries.  ``n_out`` must then be passed as
    the (static) number of stride hits in [out_offset, out_offset + nsteps);
    at least one row is always allocated (unwritten when there are no hits).

    Each kernel program runs BLOCK points.  ``interpret=True`` runs the
    kernel in the Pallas interpreter (CPU tests).

    Returns (tmp_final [LPAD, P], scal_final [NROWS, P],
             out [n_out, N_OUT_FIELDS, P]) with n_out = ceil(nsteps/out_stride)
    when out_offset is not given.
    """
    lpad, P = tmp0.shape
    assert lpad >= grid.nlayers + 2, (lpad, grid.nlayers)
    slim = aux_rows is not None
    if forcing.ndim == 5:
        n_tiles, T, nch, subl, lane = forcing.shape
        assert lane == LANE, forcing.shape
        tile_p = subl * LANE
        forcing = forcing.reshape(n_tiles, T, nch, tile_p)
    else:
        assert not slim, "the slim layout is tile-major"
        T, nch, _ = forcing.shape
        n_tiles, tile_p = 1, P
        forcing = forcing.reshape(1, T, nch, P)
    assert nch == (NCH_SLIM if slim else NCH), forcing.shape
    assert n_tiles * tile_p == P, (forcing.shape, P)
    assert P % LANE == 0, P
    nsteps = T if nsteps is None else nsteps
    assert 0 < nsteps <= T, (nsteps, T)
    if out_offset is None:
        assert n_out is None
        out_offset = 0
        n_out_total = -(-nsteps // out_stride)
    else:
        assert n_out is not None, "out_offset requires an explicit n_out"
        n_out_total = max(int(n_out), 1)
    have_cofs = slim and aux_cofs
    if have_cofs:
        assert t_total is not None and cof_red is not None
    blk = BLOCK
    assert tile_p % blk == 0, (tile_p, blk)

    kernel = _make_kernel(
        nsteps, out_stride, cfg, p,
        tuple(np.asarray(grid.dyc, np.float32).tolist()),
        tuple(np.asarray(grid.cond_dz, np.float32).tolist()),
        tuple(np.asarray(grid.wcont, np.float32).tolist()),
        bl_iters, lpad, tile_p, blk, slim=slim, have_cofs=have_cofs,
        t_total=t_total, cof_red=float(cof_red) if have_cofs else None)

    args = [jnp.asarray(out_offset, jnp.int32).reshape(1)]
    if slim:
        args.append(jnp.asarray(slim_trf, jnp.float32))
    args += [forcing, tmp0, scal0]
    if slim:
        args.append(jnp.asarray(aux_rows, jnp.float32))
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out, tmp_f, scal_f = pl.pallas_call(
        kernel,
        grid=(n_tiles, tile_p // blk),
        in_specs=[any_spec] * len(args),
        out_specs=(any_spec,) * 3,
        out_shape=(
            jax.ShapeDtypeStruct((n_out_total, N_OUT_FIELDS, P), jnp.float32),
            jax.ShapeDtypeStruct((lpad, P), jnp.float32),
            jax.ShapeDtypeStruct((NROWS, P), jnp.float32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=max(blk // 32, 1),
                                             num_stages=1),
        interpret=interpret,
        name="roadsurf_scan",
    )(*args)
    return tmp_f, scal_f, out


# ---------------------------------------------------------------------------
# packing helpers: State/Prepared <-> kernel layouts
# ---------------------------------------------------------------------------

def pack_state(state, lpad: int = None):
    """State pytree ([P] leaves, tmp [P, L+2]) -> (tmp0 [LPAD, P],
    scal0 [NROWS, P]) float32."""
    tmp = jnp.asarray(state.tmp, jnp.float32).T        # [L+2, P]
    l2, P = tmp.shape
    lpad = lpad or l2
    tmp0 = jnp.zeros((lpad, P), jnp.float32).at[:l2].set(tmp)
    rows = [None] * NROWS
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    rows[R_TSURF] = f32(state.tsurf_ave)
    rows[R_WAT] = f32(state.wat)
    rows[R_SNOW] = f32(state.snow)
    rows[R_ICE] = f32(state.ice)
    rows[R_ICE2] = f32(state.ice2)
    rows[R_DEP] = f32(state.dep)
    rows[R_Q2MELT] = f32(state.q2melt)
    rows[R_T4MELT] = f32(state.t4melt)
    rows[R_EVAP] = f32(state.evap)
    rows[R_BLCOND] = f32(state.blcond)
    rows[R_ALBEDO] = f32(state.albedo)
    rows[R_VERYCOLD] = f32(state.very_cold)
    rows[R_FAILED] = f32(state.failed)
    return tmp0, jnp.stack(rows)


def unpack_state(tmp_f, scal_f, nlayers: int, state_template):
    """Inverse of pack_state (keeps the template's dtype)."""
    dt = state_template.tmp.dtype
    return state_template._replace(
        tmp=jnp.asarray(tmp_f[:nlayers + 2].T, dt),
        tsurf_ave=jnp.asarray(scal_f[R_TSURF], dt),
        wat=jnp.asarray(scal_f[R_WAT], dt),
        snow=jnp.asarray(scal_f[R_SNOW], dt),
        ice=jnp.asarray(scal_f[R_ICE], dt),
        ice2=jnp.asarray(scal_f[R_ICE2], dt),
        dep=jnp.asarray(scal_f[R_DEP], dt),
        q2melt=jnp.asarray(scal_f[R_Q2MELT], dt),
        t4melt=jnp.asarray(scal_f[R_T4MELT], dt),
        evap=jnp.asarray(scal_f[R_EVAP], dt),
        blcond=jnp.asarray(scal_f[R_BLCOND], dt),
        albedo=jnp.asarray(scal_f[R_ALBEDO], dt),
        very_cold=scal_f[R_VERYCOLD] > 0.5,
        failed=scal_f[R_FAILED] > 0.5)


def forcing_thermo(tair, rhz):
    """Pure-forcing thermodynamics, precomputed out of the per-step kernel:
    eair (Magnus vapour pressure at the air temperature,
    BoundaryLayer.f90:156-170) and the air volumetric heat capacity
    rho_air*cp_air (BoundaryLayer.f90:33-36).  float32 in/out; shared by
    pack_forcing and the station-level prepared channels."""
    tak = tair + jnp.float32(273.15)
    air_dens = jnp.float32(100000.0) / (jnp.float32(287.05) * tak)
    air_hcap = (jnp.float32(1005.0)
                + (tak - jnp.float32(250.0)) ** 2 / jnp.float32(3364.0))
    eair = jnp.minimum(jnp.float32(0.01) * rhz, jnp.float32(1.0)) \
        * _esat(tair)
    return eair, air_hcap * air_dens


def pack_forcing(prep, sw_cof, lw_cof, coupling_tsurf):
    """Prepared ([T, P] channels) -> [T, NCH, P] float32."""
    T, P = prep.tair.shape
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    tair = f32(prep.tair)
    rhz = f32(prep.rhz)
    ch = [None] * NCH
    ch[C_TAIR] = tair
    ch[C_VZ] = f32(prep.vz)
    ch[C_EAIR], ch[C_AIRVCAP] = forcing_thermo(tair, rhz)
    ch[C_RAIN] = f32(prep.rain)
    ch[C_SNOW] = f32(prep.snow)
    ch[C_SW] = f32(prep.sw)
    ch[C_LW] = f32(prep.lw)
    ch[C_TSURF_OBS] = f32(prep.tsurf_obs)
    ch[C_VALID] = f32(prep.valid)
    ch[C_TRF] = jnp.broadcast_to(f32(prep.trf_fric)[:, None], (T, P))
    ch[C_SWCOF] = f32(sw_cof)
    ch[C_LWCOF] = f32(lw_cof)
    ch[C_INCPL] = f32(prep.in_coupling)
    ch[C_CPLOBS] = jnp.broadcast_to(
        f32(coupling_tsurf)[None, :], (T, P))
    return jnp.stack(ch, axis=1)
