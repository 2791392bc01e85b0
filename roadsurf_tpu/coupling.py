"""Observation coupling: the radiation-coefficient fitting iteration.

The reference rewinds the per-point time index up to 25 times over a coupling
window, re-running the window with adjusted SW/LW coefficients until the
simulated surface temperature matches the latest observation
(src/Coupling.f90; call sites examples/example1/src/Simulation.f90:63-71,
:92-95).  This is the only non-linear control flow in the model.

TPU-native design: a **per-point program counter**.  Each point carries its
own 1-based step index ``i`` inside one batched ``lax.while_loop``; a rewind
is just a per-point PC reset to the window start.  Points advance in lockstep
but mask independently -- diverging iteration counts, failures and window
positions all become `where`s.  Worst-case trip count is
SimLen + 26 x window, exactly the reference's per-point work bound.

Reference quirks replicated deliberately:
 * the snapshot never saves SrfIcemms -- saveDataForCoupling stores Ice2
   twice (src/Coupling.f90:194-195) -- so ice carries through rewinds;
 * q2melt/t4melt/evap/blcond are not in the snapshot either;
 * ``inCouplingPhase`` is computed from the PRE-rewind index
   (src/Coupling.f90:41-46 runs before uploadDataForCoupling), so the first
   re-run step executes with the flag false;
 * CheckValues runs on the PRE-rewind row;
 * the RadCoeff > 3.0 "failure" in the success branch is immediately
   overwritten by Coupling_failed = .false. (src/Coupling.f90:451-463), so
   it is effectively success-with-zero-correction.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import ModelSettings, PhysicsParams
from .forcing import Prepared
from .grid import LayerGrid
from .state import PointParams, State
from .step import StepConfig, StepForcing, step

K0 = 273.16  # Coupling_control works in Kelvin (src/Coupling.f90:313)


class CouplingVars(NamedTuple):
    """Per-point coupling iteration state (cf. CouplingVariables,
    src/CouplingVariables.f90.inc)."""
    sw_cof: jnp.ndarray
    lw_cof: jnp.ndarray
    sw_corr: jnp.ndarray
    lw_corr: jnp.ndarray
    radcoeff: jnp.ndarray
    radc_above: jnp.ndarray
    radc_below: jnp.ndarray
    radc_prev: jnp.ndarray
    t_above: jnp.ndarray       #: Kelvin (sentinel -9999)
    t_below: jnp.ndarray       #: Kelvin
    tsurf_end1: jnp.ndarray    #: Kelvin
    iterations: jnp.ndarray    #: int32
    again: jnp.ndarray         #: bool
    failed: jnp.ndarray        #: bool (Coupling_failed)

    @classmethod
    def init(cls, np_, dtype, coupling_tsurf):
        f = lambda v: jnp.full((np_,), v, dtype=dtype)
        return cls(
            sw_cof=f(1.0), lw_cof=f(1.0), sw_corr=f(0.0), lw_corr=f(0.0),
            radcoeff=f(1.0), radc_above=f(-9999.0), radc_below=f(-9999.0),
            radc_prev=f(1.0), t_above=f(-9999.0), t_below=f(-9999.0),
            tsurf_end1=f(0.0), iterations=jnp.zeros((np_,), jnp.int32),
            again=jnp.zeros((np_,), bool),
            # initVariablesAndParameters :142-144 -- no obs => failed
            failed=jnp.asarray(coupling_tsurf) < -100.0)


class Snapshot(NamedTuple):
    """saveDataForCoupling state subset (src/Coupling.f90:172-210)."""
    tmp: jnp.ndarray
    tsurf_ave: jnp.ndarray
    wat: jnp.ndarray
    snow: jnp.ndarray
    ice2: jnp.ndarray
    dep: jnp.ndarray
    albedo: jnp.ndarray
    very_cold: jnp.ndarray


def coupling_control(tsurf_c, obs_c, cv: CouplingVars, do: jnp.ndarray):
    """Branch-free Coupling_control (src/Coupling.f90:292-481), applied where
    ``do``; returns the updated CouplingVars (iterations already +1 per
    CouplingOperations2, src/Coupling.f90:140)."""
    t = tsurf_c + K0
    obs = obs_c + K0

    it = cv.iterations
    # branch predicates, mutually exclusive in reference order
    b_maxit = it == 25
    b_missing = (~b_maxit) & (obs < -100.0 + K0)
    b_abn = (~b_maxit) & (~b_missing) & ((t < 170.0) | (t > 400.0))
    prior = b_maxit | b_missing | b_abn
    b_above = (~prior) & (t - obs > 0.1)
    b_below = (~prior) & (~b_above) & (obs - t > 0.1)
    b_success = ~(prior | b_above | b_below)

    tsurf_end1 = jnp.where(it == 0, t, cv.tsurf_end1)

    # ---- failure branches ------------------------------------------------
    fail_any = b_maxit | b_missing | b_abn
    again_f = jnp.where(b_maxit,
                        jnp.abs(tsurf_end1 - obs) < jnp.abs(t - obs),
                        b_missing | b_abn)

    # ---- overshoot / undershoot (secant / halving / doubling) ------------
    # save-nearest updates (:366-375, :414-424)
    upd_above = b_above & ((cv.t_above < -100.0)
                           | (cv.t_above - obs > t - obs))
    t_above = jnp.where(upd_above, t, cv.t_above)
    radc_above = jnp.where(upd_above, cv.radcoeff, cv.radc_above)
    upd_below = b_below & ((cv.t_below < -100.0)
                           | (cv.t_below - obs < t - obs))
    t_below = jnp.where(upd_below, t, cv.t_below)
    radc_below = jnp.where(upd_below, cv.radcoeff, cv.radc_below)

    have_both = (t_above > -100.0) & (t_below > -100.0)
    d_above = t_above - obs
    d_below = obs - t_below
    denom = jnp.where(jnp.abs(d_above + d_below) < 1e-300, 1.0,
                      d_above + d_below)
    secant = radc_above - d_above / denom * (radc_above - radc_below)
    rad_above = jnp.where(have_both, secant, 0.5 * cv.radcoeff)
    rad_below = jnp.where(have_both, secant, 2.0 * cv.radcoeff)
    radcoeff = jnp.where(b_above, rad_above,
                         jnp.where(b_below, rad_below, cv.radcoeff))

    stuck = (b_above | b_below) & (jnp.abs(radcoeff - cv.radc_prev) < 0.00005)
    t_above = jnp.where(stuck, -9999.0, t_above)
    t_below = jnp.where(stuck, -9999.0, t_below)

    too_small = b_above & (radcoeff < 0.01)          # :400-408
    fail_any = fail_any | too_small
    radcoeff = jnp.where(too_small, 1.0, radcoeff)
    radc_prev = jnp.where(b_above | b_below, radcoeff, cv.radc_prev)

    # ---- success (:450-474); radcoeff>3 resets corrections but the branch
    # ends NOT failed (the reference overwrites the flag) ------------------
    big = b_success & (cv.radcoeff > 3.0)
    sw_cof_s = jnp.where(big, 1.0, cv.sw_cof)
    lw_cof_s = jnp.where(big, 1.0, cv.lw_cof)
    sw_corr_s = sw_cof_s - 1.0
    lw_corr_s = lw_cof_s - 1.0

    # ---- merge -----------------------------------------------------------
    reset_cof = fail_any
    sw_cof = jnp.where(reset_cof, 1.0, jnp.where(b_success, sw_cof_s, cv.sw_cof))
    lw_cof = jnp.where(reset_cof, 1.0, jnp.where(b_success, lw_cof_s, cv.lw_cof))
    sw_corr = jnp.where(reset_cof, 0.0,
                        jnp.where(b_success, sw_corr_s, cv.sw_corr))
    lw_corr = jnp.where(reset_cof, 0.0,
                        jnp.where(b_success, lw_corr_s, cv.lw_corr))
    radcoeff = jnp.where(fail_any | b_success, 1.0, radcoeff)
    t_above = jnp.where(b_success, -9999.0, t_above)
    t_below = jnp.where(b_success, -9999.0, t_below)
    radc_above = jnp.where(b_success, -9999.0, radc_above)
    radc_below = jnp.where(b_success, -9999.0, radc_below)
    radc_prev = jnp.where(b_success, 1.0, radc_prev)

    again = again_f | b_above | b_below
    failed = fail_any | (cv.failed & ~b_success)
    failed = jnp.where(b_success, False, failed)
    it_next = jnp.where(b_success, jnp.int32(0), it + 1)

    out = CouplingVars(
        sw_cof=jnp.where(do, sw_cof, cv.sw_cof),
        lw_cof=jnp.where(do, lw_cof, cv.lw_cof),
        sw_corr=jnp.where(do, sw_corr, cv.sw_corr),
        lw_corr=jnp.where(do, lw_corr, cv.lw_corr),
        radcoeff=jnp.where(do, radcoeff, cv.radcoeff),
        radc_above=jnp.where(do, radc_above, cv.radc_above),
        radc_below=jnp.where(do, radc_below, cv.radc_below),
        radc_prev=jnp.where(do, radc_prev, cv.radc_prev),
        t_above=jnp.where(do, t_above, cv.t_above),
        t_below=jnp.where(do, t_below, cv.t_below),
        tsurf_end1=jnp.where(do, tsurf_end1, cv.tsurf_end1),
        iterations=jnp.where(do, it_next, cv.iterations),
        again=jnp.where(do, again, cv.again),
        failed=jnp.where(do, failed, cv.failed))
    return out


class Carry(NamedTuple):
    state: State
    cv: CouplingVars
    snap: Snapshot
    i: jnp.ndarray            #: [P] int32, 1-based PC
    in_coupling: jnp.ndarray  #: [P] bool, melting-guard flag
    out: jnp.ndarray          #: [P, n_out, 6]


def _restore(state: State, snap: Snapshot, do):
    """uploadDataForCoupling (src/Coupling.f90:213-255): restore the snapshot
    subset (note: NOT ice, NOT q2melt/t4melt/evap/blcond)."""
    w = lambda n, o: jnp.where(do, n, o)
    return state._replace(
        tmp=jnp.where(do[..., None], snap.tmp, state.tmp),
        tsurf_ave=w(snap.tsurf_ave, state.tsurf_ave),
        wat=w(snap.wat, state.wat),
        snow=w(snap.snow, state.snow),
        ice2=w(snap.ice2, state.ice2),
        dep=w(snap.dep, state.dep),
        albedo=w(snap.albedo, state.albedo),
        very_cold=w(snap.very_cold, state.very_cold))


def _save(state: State, snap: Snapshot, do) -> Snapshot:
    w = lambda n, o: jnp.where(do, n, o)
    return Snapshot(
        tmp=jnp.where(do[..., None], state.tmp, snap.tmp),
        tsurf_ave=w(state.tsurf_ave, snap.tsurf_ave),
        wat=w(state.wat, snap.wat),
        snow=w(state.snow, snap.snow),
        ice2=w(state.ice2, snap.ice2),
        dep=w(state.dep, snap.dep),
        albedo=w(state.albedo, snap.albedo),
        very_cold=w(state.very_cold, snap.very_cold))


def run_coupled(state: State, prep: Prepared, pts: PointParams,
                settings: ModelSettings, cfg: StepConfig, grid: LayerGrid,
                p: PhysicsParams, out_stride: int = 1, depth=None):
    """Full simulation with coupling via the per-point-PC while_loop.

    Returns (final_state, out [n_out, P, 6]) where
    n_out = ceil(sim_len / out_stride); out[k] is the output of 1-based step
    k*out_stride + 1 (stride 1 == every step, matching SaveOutput).
    """
    from .physics import storage as storage_mod

    T = settings.sim_len
    P = state.tsurf_ave.shape[0]
    dtype = state.tmp.dtype
    n_out = -(-T // out_stride)

    dyc = jnp.asarray(grid.dyc, dtype)
    cond_dz = jnp.asarray(grid.cond_dz, dtype)
    wcont = jnp.asarray(grid.wcont, dtype)

    start_i = pts.coupling_start.astype(jnp.int32)
    end_i = pts.coupling_end.astype(jnp.int32)
    obs = jnp.asarray(pts.coupling_tsurf, dtype)
    coupling_on = (jnp.asarray(settings.use_coupling)
                   & (end_i >= 1) & (obs > -100.0))
    sky_active = (pts.sky_view < 1.0) & (pts.sky_view > -0.01)

    # cof-choice at restore (src/Coupling.f90:66-77): SW if SW(i)>LW(i) at the
    # window start and sky view unused.  sw/lw prep channels equal the pristine
    # inputs when sky view is inactive, which is the only case the SW branch
    # can take.
    sp = jnp.clip(start_i - 1, 0, T - 1)
    pr = jnp.arange(P)
    choice_sw = (prep.sw[sp, pr] > prep.lw[sp, pr]) & (~sky_active)

    cv0 = CouplingVars.init(P, dtype, obs)
    # setInputParam / initCouplingTimes disable: treat disabled points as
    # never-coupled (coupling_on False); their cv stays inert.
    snap0 = Snapshot(
        tmp=jnp.zeros_like(state.tmp), tsurf_ave=jnp.zeros_like(obs),
        wat=jnp.zeros_like(obs), snow=jnp.zeros_like(obs),
        ice2=jnp.zeros_like(obs), dep=jnp.zeros_like(obs),
        albedo=jnp.zeros_like(obs), very_cold=jnp.zeros(P, bool))
    out0 = jnp.full((P, n_out, 6), -9999.0, dtype)
    carry0 = Carry(state=state, cv=cv0, snap=snap0,
                   i=jnp.ones((P,), jnp.int32),
                   in_coupling=jnp.zeros((P,), bool), out=out0)

    def gather(ch, ip):
        return ch[ip, pr]

    def cond_fn(c: Carry):
        return jnp.any((c.i < T) & (~c.state.failed))

    def body(c: Carry) -> Carry:
        st, cv, snap = c.state, c.cv, c.snap
        i = c.i
        active = (i < T) & (~st.failed)
        ip_pre = jnp.clip(i - 1, 0, T - 1)

        # CheckValues on the PRE-rewind row; include the abnormal-tsurf check
        # on the PRE-restore state (src/InputOutput.f90:45-84)
        valid = gather(prep.valid, ip_pre)
        valid = valid & ~((st.tsurf_ave < -100.0) | (st.tsurf_ave > 100.0))

        # ---- CouplingOperations1 (src/Coupling.f90:10-96) --------------
        cpl_act = coupling_on & active
        in_cpl = cpl_act & (i >= start_i) & (i <= end_i)   # pre-rewind flag
        in_coupling = jnp.where(active, in_cpl, c.in_coupling)

        do_save = cpl_act & (i == start_i) & (cv.iterations == 0)
        snap = _save(st, snap, do_save)
        cv = cv._replace(
            sw_cof=jnp.where(do_save, 1.0, cv.sw_cof),
            lw_cof=jnp.where(do_save, 1.0, cv.lw_cof),
            sw_corr=jnp.where(do_save, 0.0, cv.sw_corr),
            lw_corr=jnp.where(do_save, 0.0, cv.lw_corr))

        do_restore = cpl_act & cv.again
        st = _restore(st, snap, do_restore)
        i = jnp.where(do_restore, start_i, i)
        cv = cv._replace(
            again=cv.again & ~do_restore,
            sw_cof=jnp.where(do_restore,
                             jnp.where(choice_sw, cv.radcoeff, 1.0),
                             cv.sw_cof),
            lw_cof=jnp.where(do_restore,
                             jnp.where(choice_sw, 1.0, cv.radcoeff),
                             cv.lw_cof))

        # decay after the window (:82-88), with the post-rewind index
        past = cpl_act & (i > end_i)
        dts = settings.dt
        dec = jnp.exp(-((dts * i.astype(dtype))
                        - (dts * end_i.astype(dtype)))
                      / settings.coupling_effect_reduction)
        sw_cof = jnp.where(past, 1.0 + cv.sw_corr * dec, cv.sw_cof)
        lw_cof = jnp.where(past, 1.0 + cv.lw_corr * dec, cv.lw_cof)
        cv = cv._replace(sw_cof=sw_cof, lw_cof=lw_cof)

        # snowIceCheck inside the window (pre-rewind flag, post-restore state)
        checked = storage_mod.snow_ice_check(
            storage_mod.Storages(st.wat, st.snow, st.ice, st.ice2, st.dep),
            obs, p)
        sel = in_cpl
        st = st._replace(
            wat=jnp.where(sel, checked.wat, st.wat),
            snow=jnp.where(sel, checked.snow, st.snow),
            ice=jnp.where(sel, checked.ice, st.ice),
            ice2=jnp.where(sel, checked.ice2, st.ice2),
            dep=jnp.where(sel, checked.dep, st.dep))

        # ---- the step at the (possibly rewound) index ------------------
        ip = jnp.clip(i - 1, 0, T - 1)
        f = StepForcing(
            tair=gather(prep.tair, ip), vz=gather(prep.vz, ip),
            rhz=gather(prep.rhz, ip), rain=gather(prep.rain, ip),
            snow=gather(prep.snow, ip), sw=gather(prep.sw, ip),
            lw=gather(prep.lw, ip), tsurf_obs=gather(prep.tsurf_obs, ip),
            valid=valid, in_coupling=in_cpl,
            trf_fric=prep.trf_fric[ip], sw_cof=cv.sw_cof, lw_cof=cv.lw_cof)
        stepped = step(st, f, obs, cfg, dyc, cond_dz, wcont, p, depth=depth)
        st_new = jax.tree.map(
            lambda n, o: jnp.where(
                active.reshape(active.shape + (1,) * (n.ndim - active.ndim)),
                n, o), stepped, st)

        # ---- SaveOutput scatter (out[i-1] when on stride) ---------------
        fields = jnp.stack([st_new.tsurf_ave, st_new.wat, st_new.snow,
                            st_new.ice, st_new.ice2, st_new.dep], axis=-1)
        fields = jnp.where(st.failed[..., None], -9999.0, fields)
        on_stride = (ip % out_stride) == 0
        slot = jnp.where(active & on_stride, ip // out_stride, n_out)
        out = c.out.at[pr, slot].set(fields, mode="drop")

        # ---- CheckEndCoupling (src/Coupling.f90:98-118) -----------------
        do_control = cpl_act & (i == end_i) & (~cv.failed) & (~st_new.failed)
        cv = coupling_control(st_new.tsurf_ave, obs, cv, do_control)

        i_next = jnp.where(active, i + 1, i)
        return Carry(state=st_new, cv=cv, snap=snap, i=i_next,
                     in_coupling=in_coupling, out=out)

    final = jax.lax.while_loop(cond_fn, body, carry0)
    return _last_values(final.state, final.cv, final.in_coupling, prep, pts,
                        cfg, grid, p, T, n_out, out_stride, final.out,
                        depth=depth)


def _last_values(st, cv, in_coupling, prep, pts, cfg, grid, p, T, n_out,
                 out_stride, out, depth=None):
    """The final step (lastValues; Simulation.f90:100-113) shared by the
    per-point-PC and segmented coupled engines."""
    from .physics.soil import surface_average

    dtype = st.tmp.dtype
    P = st.tsurf_ave.shape[0]
    obs = jnp.asarray(pts.coupling_tsurf, dtype)
    dyc = jnp.asarray(grid.dyc, dtype)
    cond_dz = jnp.asarray(grid.cond_dz, dtype)
    wcont = jnp.asarray(grid.wcont, dtype)
    pr = jnp.arange(P)
    ip = T - 1
    ok = ~st.failed
    f = StepForcing(
        tair=prep.tair[ip], vz=prep.vz[ip], rhz=prep.rhz[ip],
        rain=prep.rain[ip], snow=prep.snow[ip], sw=prep.sw[ip],
        lw=prep.lw[ip], tsurf_obs=jnp.full((P,), -9999.9, dtype),
        valid=jnp.ones((P,), bool), in_coupling=in_coupling,
        trf_fric=prep.trf_fric[ip], sw_cof=cv.sw_cof, lw_cof=cv.lw_cof)
    # lastValues recomputes TsurfAve from the committed profile first
    didx, dw, duse = depth if depth is not None else (
        cfg.depth_idx, cfg.depth_w, cfg.use_depth)
    tmp0 = st.tmp.at[..., 0].set(jnp.where(ok, f.tair, st.tmp[..., 0]))
    st = st._replace(
        tmp=tmp0,
        tsurf_ave=jnp.where(ok, surface_average(tmp0, didx, dw, duse),
                            st.tsurf_ave))
    stepped = step(st, f, obs, cfg, dyc, cond_dz, wcont, p, depth=depth)
    st_final = jax.tree.map(
        lambda n, o: jnp.where(
            ok.reshape(ok.shape + (1,) * (n.ndim - ok.ndim)), n, o),
        stepped, st)
    fields = jnp.stack([st_final.tsurf_ave, st_final.wat, st_final.snow,
                        st_final.ice, st_final.ice2, st_final.dep], axis=-1)
    fields = jnp.where((~ok)[..., None], -9999.0, fields)
    on_stride = (ip % out_stride) == 0
    slot = jnp.where(ok & on_stride, ip // out_stride, n_out)
    out = out.at[pr, slot].set(fields, mode="drop")
    # failed points keep their poison row for the final slot too
    return st_final, jnp.swapaxes(out, 0, 1)


# ---------------------------------------------------------------------------
# Segmented coupled engine: iteration-major window re-runs
# ---------------------------------------------------------------------------
#
# The per-point-PC engine above replays the reference's control flow exactly,
# but every step gathers 8 forcing channels at per-point row indices from
# [T, P] device arrays -- a gather-bound pattern.  The segmented engine
# re-organizes the SAME per-point step sequences into three phases so the hot
# path is contiguous row slices:
#
#   phase A  [1, ws-1]   plain scan, no coupling state touched
#   phase B  [ws, we_b]  the global coupling window (ws = min coupling_start,
#                        we_b = min(max coupling_end, T-1)):
#            pass "first":  every point steps; coupled points stop at their
#                           own end_i (snapshot at start_i, control at end_i)
#            pass "rerun":  a lax.while_loop; each trip restores the snapshot
#                           for points whose control said rewind and replays
#                           ONLY their [start_i, end_i], masked
#            pass "tail":   coupled points step (end_i, we_b] with the decayed
#                           radiation coefficients
#   phase C  [we_b+1, T]  plain scan with the decay folded into per-step
#                         sw_cof/lw_cof channels (forcing.cof_window)
#
# Every executed (point, step) pair sees bit-identical inputs to the PC
# engine (incl. the pre-rewind quirks: first re-run step has in_coupling
# False, CheckValues row end_i, abnormal-tsurf test on the PRE-restore
# state), so the two engines agree bitwise in float64
# (tests/test_coupling_segmented.py).  Reference: src/Coupling.f90:10-140,
# examples/example1/src/Simulation.f90:58-95.


class WindowResult(NamedTuple):
    state: "State"            #: state after step we_b
    cv: "CouplingVars"        #: final coupling vars (sw_corr/lw_corr set)
    out: jnp.ndarray          #: [n_out_b, P, 6] window output rows
    in_coupling: jnp.ndarray  #: [P] flag after the last window step
    reruns: jnp.ndarray       #: scalar int32: window re-run passes executed


def window_out_rows(ws: int, we_b: int, out_stride: int):
    """Global 0-based output rows the window emits: r in [ws-1, we_b-1] with
    r %% out_stride == 0."""
    import numpy as _np
    first = -(-(ws - 1) // out_stride) * out_stride
    return _np.arange(first, we_b, out_stride, dtype=_np.int64)


def run_window_passes(state: State, provider, valid_win, ws: int, we_b: int,
                      pts: PointParams, settings: ModelSettings,
                      cfg: StepConfig, grid: LayerGrid, p: PhysicsParams,
                      out_stride: int = 1, depth=None, wchunk: int = 64,
                      cv: CouplingVars = None) -> WindowResult:
    """Execute the global coupling window [ws, we_b] (1-based steps).

    ``provider(t0)`` -> Prepared chunk with [wchunk, P] leaves covering
    global 0-based forcing rows [t0, t0+wchunk) (t0 is a TRACED int32 row
    offset, always a multiple of wchunk past ws-1 and in-bounds; rows beyond
    we_b-1 are masked off and may hold arbitrary finite data).
    ``valid_win``: [we_b - ws + 2, P] bool, prep.valid rows ws-1 .. we_b
    (the +1 row feeds the re-run first-step CheckValues quirk).
    ``state``: after step ws-1.  Returns state after step we_b.
    """
    from .physics import storage as storage_mod

    T = settings.sim_len
    P = state.tsurf_ave.shape[0]
    dtype = state.tmp.dtype
    W = we_b - ws + 1
    assert W >= 1 and we_b <= T - 1, (ws, we_b, T)
    wchunk = min(wchunk, W)
    nchunks = -(-W // wchunk)

    dyc = jnp.asarray(grid.dyc, dtype)
    cond_dz = jnp.asarray(grid.cond_dz, dtype)
    wcont = jnp.asarray(grid.wcont, dtype)

    start_i = jnp.asarray(pts.coupling_start, jnp.int32)
    end_i = jnp.asarray(pts.coupling_end, jnp.int32)
    obs = jnp.asarray(pts.coupling_tsurf, dtype)
    coupled = (jnp.asarray(settings.use_coupling)
               & (end_i >= 1) & (obs > -100.0))
    sky_active = (pts.sky_view < 1.0) & (pts.sky_view > -0.01)

    if cv is None:
        cv = CouplingVars.init(P, dtype, obs)
    snap0 = Snapshot(
        tmp=jnp.zeros_like(state.tmp), tsurf_ave=jnp.zeros_like(obs),
        wat=jnp.zeros_like(obs), snow=jnp.zeros_like(obs),
        ice2=jnp.zeros_like(obs), dep=jnp.zeros_like(obs),
        albedo=jnp.zeros_like(obs), very_cold=jnp.zeros(P, bool))

    out_rows = window_out_rows(ws, we_b, out_stride)
    n_out_b = max(len(out_rows), 1)
    first_hit = int(out_rows[0]) if len(out_rows) else 0
    out0 = jnp.full((n_out_b, P, 6), -9999.0, dtype)
    choice0 = jnp.zeros((P,), bool)

    tau = settings.coupling_effect_reduction
    dts = settings.dt

    def abnormal(st):
        return (st.tsurf_ave < -100.0) | (st.tsurf_ave > 100.0)

    pr = jnp.arange(P)
    vrow_idx = jnp.clip(end_i - (ws - 1), 0, valid_win.shape[0] - 1)

    def rr_mask(st, cv):
        # a point whose window ends at step T-1 never rewinds: the rewind
        # fires at i = end_i + 1, and the PC loop stops at i < T
        return cv.again & coupled & (end_i + 1 < T) & (~st.failed)

    # Pass modes carried as a TRACED scalar so the whole phase is ONE
    # lax.while_loop with ONE instance of the step graph (three structural
    # variants would triple the HLO and its compile time).
    M_FIRST, M_RERUN, M_TAIL, M_DONE = 0, 1, 2, 3

    def row_fn(carry, xs):
        st, cv, snap, choice, out, mode, rr, vf = carry
        (tair, vz, rhz, rain, snowf, sw, lw, tobs, vld, trf), i = xs
        i = i.astype(jnp.int32)
        is_first = mode == M_FIRST
        is_rerun = mode == M_RERUN
        is_tail = mode == M_TAIL
        run = (i >= ws) & (i <= we_b)          # scalar: padded chunk rows
        entry_ok = ~st.failed
        in_window = (i >= start_i) & (i <= end_i)

        mode_mask = jnp.where(
            is_first, jnp.where(coupled, i <= end_i, True),
            jnp.where(is_rerun, rr & in_window, coupled & (i > end_i)))
        act = run & mode_mask & entry_ok

        # saveDataForCoupling + cof reset, first pass only
        # (src/Coupling.f90:55-64); the cof-choice input
        # (src/Coupling.f90:66-77) is captured at the window-start row
        at_start = act & coupled & (i == start_i)
        do_save = is_first & at_start & (cv.iterations == 0)
        snap = _save(st, snap, do_save)
        cv = cv._replace(
            sw_cof=jnp.where(do_save, 1.0, cv.sw_cof),
            lw_cof=jnp.where(do_save, 1.0, cv.lw_cof),
            sw_corr=jnp.where(do_save, 0.0, cv.sw_corr),
            lw_corr=jnp.where(do_save, 0.0, cv.lw_corr))
        choice = jnp.where(is_first & at_start,
                           (sw > lw) & (~sky_active), choice)

        # pre-rewind flag: the first re-run step (i == start_i) ran with
        # i = end_i + 1 before the rewind -> flag False
        in_cpl = act & jnp.where(
            is_first, coupled & in_window,
            is_rerun & (i > start_i) & (i <= end_i))

        # CheckValues (+ abnormal tsurf on the body-entry state); the first
        # re-run step uses the pre-rewind row end_i (vf, set at pass entry)
        vld_step = vld & ~abnormal(st)
        vld_step = jnp.where(is_rerun & act & (i == start_i), vf, vld_step)

        # snowIceCheck inside the window (src/Coupling.f90:259-289)
        checked = storage_mod.snow_ice_check(
            storage_mod.Storages(st.wat, st.snow, st.ice, st.ice2, st.dep),
            obs, p)
        st = st._replace(
            wat=jnp.where(in_cpl, checked.wat, st.wat),
            snow=jnp.where(in_cpl, checked.snow, st.snow),
            ice=jnp.where(in_cpl, checked.ice, st.ice),
            ice2=jnp.where(in_cpl, checked.ice2, st.ice2),
            dep=jnp.where(in_cpl, checked.dep, st.dep))

        # post-window decay, tail pass only (src/Coupling.f90:82-88)
        expo = -(dts * i.astype(dtype) - dts * end_i.astype(dtype)) / tau
        dec = jnp.exp(jnp.minimum(expo, 0.0))
        tail_act = is_tail & act
        swc = jnp.where(tail_act, 1.0 + cv.sw_corr * dec, cv.sw_cof)
        lwc = jnp.where(tail_act, 1.0 + cv.lw_corr * dec, cv.lw_cof)

        f = StepForcing(tair=tair, vz=vz, rhz=rhz, rain=rain, snow=snowf,
                        sw=sw, lw=lw, tsurf_obs=tobs, valid=vld_step,
                        in_coupling=in_cpl, trf_fric=trf,
                        sw_cof=swc, lw_cof=lwc)
        stepped = step(st, f, obs, cfg, dyc, cond_dz, wcont, p, depth=depth)
        st_new = jax.tree.map(
            lambda n, o: jnp.where(
                act.reshape(act.shape + (1,) * (n.ndim - act.ndim)),
                n, o), stepped, st)

        # SaveOutput row (overwritten by later re-runs where active)
        on = ((i - 1) % out_stride) == 0
        slot = jnp.clip((i - 1 - first_hit) // out_stride, 0, n_out_b - 1)
        fields = jnp.stack(
            [st_new.tsurf_ave, st_new.wat, st_new.snow, st_new.ice,
             st_new.ice2, st_new.dep], axis=-1)
        fields = jnp.where(st.failed[..., None], -9999.0, fields)
        row_old = jax.lax.dynamic_slice_in_dim(out, slot, 1, axis=0)[0]
        merged = jnp.where((act & on)[..., None], fields, row_old)
        out = jax.lax.dynamic_update_slice_in_dim(
            out, merged[None], slot, axis=0)

        # CheckEndCoupling (src/Coupling.f90:98-118), never in the tail
        do_ctl = ((~is_tail) & act & coupled & (i == end_i) & (~cv.failed)
                  & (~st_new.failed))
        cv = coupling_control(st_new.tsurf_ave, obs, cv, do_ctl)

        return (st_new, cv, snap, choice, out, mode, rr, vf), None

    def chunk_body(c, t0):
        prep_c = provider(t0)
        trf = jnp.broadcast_to(
            jnp.asarray(prep_c.trf_fric, dtype)[:, None], (wchunk, P))
        xs = ((prep_c.tair, prep_c.vz, prep_c.rhz, prep_c.rain,
               prep_c.snow, prep_c.sw, prep_c.lw, prep_c.tsurf_obs,
               prep_c.valid, trf),
              t0 + 1 + jnp.arange(wchunk, dtype=jnp.int32))
        c, _ = jax.lax.scan(row_fn, c, xs)
        return c, None

    def pass_body(carry_n):
        carry, n = carry_n
        st0_, cv0_, _, _, _, mode0, rr0, _ = carry
        # pass-narrowing: a re-run pass only needs the chunks covering the
        # still-rewinding points' [min start, max end]; the tail pass only
        # the rows past the earliest coupled window end.  Masked rows are
        # exact no-ops, so skipping their chunks is bitwise-identical --
        # it just cuts the worst-case replay (<=25x) to the active span.
        big = jnp.int32(2 * T + 2)
        is_rerun0 = mode0 == M_RERUN
        is_tail0 = mode0 == M_TAIL
        lo_rr = jnp.min(jnp.where(rr0, start_i, big))
        hi_rr = jnp.max(jnp.where(rr0, end_i, -1))
        lo_tail = jnp.min(jnp.where(coupled, end_i, big)) + 1
        lo_i = jnp.where(is_rerun0, lo_rr,
                         jnp.where(is_tail0, lo_tail, jnp.int32(ws)))
        hi_i = jnp.where(is_rerun0, hi_rr, jnp.int32(we_b))
        k_lo = jnp.clip((lo_i - ws) // wchunk, 0, nchunks).astype(jnp.int32)
        k_hi = jnp.clip((hi_i - ws) // wchunk + 1, k_lo,
                        nchunks).astype(jnp.int32)

        def body(k, c):
            t0 = (ws - 1 + wchunk * k).astype(jnp.int32)
            c, _ = chunk_body(c, t0)
            return c

        carry = jax.lax.fori_loop(k_lo, k_hi, body, carry)
        st, cv, snap, choice, out, mode, rr, vf = carry
        # transition: enter (another) re-run round while any point's control
        # asked to rewind, else run the tail exactly once, then stop
        rr2 = rr_mask(st, cv)
        enter_rerun = (mode <= M_RERUN) & jnp.any(rr2)
        next_mode = jnp.where(mode == M_TAIL, M_DONE,
                              jnp.where(enter_rerun, M_RERUN, M_TAIL))
        do_r = rr2 & enter_rerun
        # CheckValues of the pre-rewind row end_i on the PRE-restore state
        vf2 = valid_win[vrow_idx, pr] & ~abnormal(st)
        st = _restore(st, snap, do_r)
        cv = cv._replace(
            again=cv.again & ~do_r,
            sw_cof=jnp.where(do_r, jnp.where(choice, cv.radcoeff, 1.0),
                             cv.sw_cof),
            lw_cof=jnp.where(do_r, jnp.where(choice, 1.0, cv.radcoeff),
                             cv.lw_cof))
        vf = jnp.where(enter_rerun, vf2, vf)
        return ((st, cv, snap, choice, out, next_mode.astype(jnp.int32),
                 do_r, vf), n + enter_rerun.astype(jnp.int32))

    carry0 = ((state, cv, snap0, choice0, out0, jnp.int32(M_FIRST),
               jnp.zeros((P,), bool), jnp.zeros((P,), bool)), jnp.int32(0))
    (carry, nreruns) = jax.lax.while_loop(
        lambda cn: cn[0][5] < M_DONE, pass_body, carry0)
    st, cv, snap, choice, out = carry[:5]

    in_cpl_last = coupled & (we_b >= start_i) & (we_b <= end_i)
    return WindowResult(state=st, cv=cv, out=out, in_coupling=in_cpl_last,
                        reruns=nreruns)


def run_coupled_segmented(state: State, prep: Prepared, pts: PointParams,
                          settings: ModelSettings, cfg: StepConfig,
                          grid: LayerGrid, p: PhysicsParams,
                          out_stride: int = 1, depth=None, wchunk: int = 64):
    """run_coupled via the segmented engine (scan phases A/C + iteration-major
    window).  Same signature and bitwise-identical float64 results; the
    production driver swaps phases A/C for the streamed Pallas engine."""
    from .forcing import cof_window
    from .model import scan_steps

    T = settings.sim_len
    P = state.tsurf_ave.shape[0]
    dtype = state.tmp.dtype
    n_out = -(-T // out_stride)
    import numpy as _np
    start_np = _np.asarray(pts.coupling_start)
    end_np = _np.asarray(pts.coupling_end)
    coupled_np = (bool(settings.use_coupling)
                  & (end_np >= 1) & (_np.asarray(pts.coupling_tsurf) > -100.0))
    obs = jnp.asarray(pts.coupling_tsurf, dtype)

    have_window = bool(coupled_np.any())
    if have_window:
        ws = max(int(start_np[coupled_np].min()), 1)
        we_b = int(min(end_np[coupled_np].max(), T - 1))
        have_window = ws <= we_b
    cv = CouplingVars.init(P, dtype, obs)

    out = jnp.full((P, n_out, 6), -9999.0, dtype)
    pr = jnp.arange(P)

    def commit_rows(out, sim, t_lo):
        """Fold a collected scan segment (SimOutput, rows t_lo..) into the
        global strided buffer."""
        rows = _np.arange(t_lo, t_lo + sim.tsurf.shape[0])
        hit = rows % out_stride == 0
        if not hit.any():
            return out
        rsel = _np.nonzero(hit)[0]
        fields = jnp.stack([sim.tsurf[rsel], sim.wat[rsel], sim.snow[rsel],
                            sim.ice[rsel], sim.ice2[rsel], sim.dep[rsel]],
                           axis=-1)                       # [k, P, 6]
        slots = rows[rsel] // out_stride
        return out.at[:, jnp.asarray(slots)].set(
            jnp.swapaxes(fields, 0, 1))

    def seg(x, lo, hi):
        return jax.tree.map(lambda a: a[lo:hi], x)

    ones = lambda n: jnp.ones((n, P), dtype)

    if not have_window:
        final, sim = scan_steps(state, seg(prep, 0, T - 1), ones(T - 1),
                                ones(T - 1), obs, cfg, grid, p,
                                collect=True, depth=depth)
        out = commit_rows(out, sim, 0)
        return _last_values(final, cv, jnp.asarray(prep.in_coupling[T - 1]),
                            prep, pts, cfg, grid, p, T, n_out, out_stride,
                            out, depth=depth)

    # ---- phase A ---------------------------------------------------------
    if ws > 1:
        state, sim = scan_steps(state, seg(prep, 0, ws - 1), ones(ws - 1),
                                ones(ws - 1), obs, cfg, grid, p,
                                collect=True, depth=depth)
        out = commit_rows(out, sim, 0)

    # ---- phase B ---------------------------------------------------------
    W = we_b - ws + 1
    wck = min(wchunk, W)
    W_pad = -(-W // wck) * wck
    wprep = jax.tree.map(
        lambda a: jnp.concatenate(
            [a[ws - 1:ws - 1 + W_pad]]
            + ([jnp.repeat(a[we_b - 1:we_b], ws - 1 + W_pad - T, axis=0)]
               if ws - 1 + W_pad > T else []), axis=0), prep)
    provider = lambda t0: jax.tree.map(
        lambda a: jax.lax.dynamic_slice_in_dim(a, t0 - (ws - 1), wck,
                                               axis=0), wprep)
    valid_win = prep.valid[ws - 1: we_b + 1]

    res = run_window_passes(state, provider, valid_win, ws, we_b, pts,
                            settings, cfg, grid, p, out_stride=out_stride,
                            depth=depth, wchunk=wck)
    rows_b = window_out_rows(ws, we_b, out_stride)
    if len(rows_b):
        out = out.at[:, jnp.asarray(rows_b // out_stride)].set(
            jnp.swapaxes(res.out[:len(rows_b)], 0, 1))
    state, cv = res.state, res.cv

    # ---- phase C ---------------------------------------------------------
    if we_b < T - 1:
        swc, lwc = cof_window(cv.sw_corr, cv.lw_corr, pts.coupling_end,
                              we_b, T - 1 - we_b, T, settings, dtype)
        state, sim = scan_steps(state, seg(prep, we_b, T - 1), swc, lwc,
                                obs, cfg, grid, p, collect=True, depth=depth)
        out = commit_rows(out, sim, we_b)

    # ---- final step ------------------------------------------------------
    fin_cof = cof_window(cv.sw_corr, cv.lw_corr, pts.coupling_end,
                         T - 1, 1, T, settings, dtype)
    cv = cv._replace(sw_cof=fin_cof[0][0], lw_cof=fin_cof[1][0])
    # the PC engine's final-step flag is the analytic flag at step T-1,
    # which prepare() already encodes in the last in_coupling row
    return _last_values(state, cv, jnp.asarray(prep.in_coupling[T - 1]),
                        prep, pts, cfg, grid, p, T, n_out, out_stride, out,
                        depth=depth)
