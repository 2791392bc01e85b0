"""Segmented coupled engine parity.

The iteration-major segmented engine (coupling.run_coupled_segmented) must
reproduce the per-point-PC engine (coupling.run_coupled) bitwise in float64:
every executed (point, step) pair sees identical inputs by construction, so
any difference is a re-sequencing bug.  Also adds the coupled+skyview oracle
parity case (src/Coupling.f90:66-77 coefficient choice with sky view active).
"""
import numpy as np
import pytest

from roadsurf_tpu.config import ModelSettings, PhysicsParams
from roadsurf_tpu.coupling import run_coupled_segmented
from roadsurf_tpu.io.driver import derive_point_params
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model
from roadsurf_tpu.oracle import Oracle, OraclePoint


def build_case(scenario, sim_len=721, npoints=4, seed=11, dt=30.0,
               coupling_minutes=60, use_relaxation=False, obs_shift=0.0,
               sky_view=None):
    settings = ModelSettings(sim_len=sim_len, dt=dt, use_coupling=True,
                             use_relaxation=use_relaxation,
                             coupling_minutes=coupling_minutes)
    raw, cal = synthetic_raw(npoints, sim_len, dt=dt, seed=seed,
                             scenario=scenario)
    if obs_shift:
        obs = np.asarray(raw.tsurf_obs).copy()
        obs[obs > -100.0] += obs_shift
        raw = raw._replace(tsurf_obs=obs)
    obs_tair = np.where(np.asarray(raw.tsurf_obs) > -100.0,
                        np.asarray(raw.tair), -9999.9)
    pts, blanked = derive_point_params(raw, settings, obs_tair=obs_tair)
    raw = raw._replace(tsurf_obs=blanked)
    if sky_view is not None:
        pts = pts._replace(sky_view=np.full(npoints, sky_view))
    model = Model(settings)
    return model, raw, pts, cal, settings


def run_both(scenario, out_stride=1, wchunk=16, **kw):
    model, raw, pts, cal, settings = build_case(scenario, **kw)
    _, out_pc = model.run_coupled(raw, pts, cal, out_stride=out_stride)

    prep = model.prepare(raw, pts, cal)
    state = model.init(raw, cal, dtype=prep.tair.dtype, pts=pts)
    _, out_seg = run_coupled_segmented(
        state, prep, pts, settings, model.cfg, model.grid, model.params,
        out_stride=out_stride, wchunk=wchunk)

    a, b = np.asarray(out_pc), np.asarray(out_seg)
    assert a.shape == b.shape
    # in-window rows are bitwise identical (same ops, same order); the
    # post-window decay rows may differ by 1 ulp because XLA:CPU's exp
    # vectorizes differently over [T, P] (cof_window) than over [P] inside
    # the PC while_loop -- so the global bar is 1e-12, still ~1e3x tighter
    # than the oracle parity bar
    we = int(np.max(np.asarray(pts.coupling_end)))
    ws = (we // out_stride) + 1
    np.testing.assert_array_equal(
        a[:ws], b[:ws], err_msg=f"segmented != PC in-window ({scenario})")
    np.testing.assert_allclose(
        a, b, rtol=1e-12, atol=1e-12,
        err_msg=f"segmented != PC for scenario {scenario}")
    assert np.any(pts.coupling_end > 0)
    return pts


def test_segmented_winter():
    run_both("winter_mix", seed=11)


def test_segmented_forced_rewinds():
    # large obs offsets force many secant/halving iterations
    run_both("winter_mix", seed=13, obs_shift=4.0)
    run_both("warm_rain", seed=14, obs_shift=-4.0)


def test_segmented_relaxation_and_stride():
    run_both("winter_mix", seed=15, use_relaxation=True, out_stride=3)


def test_segmented_window_to_end():
    # observation at the second-to-last step: rewinds disabled at i=T-1,
    # the window tail reaches the lastValues step
    run_both("winter_mix", sim_len=481, seed=16, coupling_minutes=30)


def test_segmented_skyview():
    run_both("winter_mix", seed=17, sky_view=0.6, obs_shift=2.0)


def test_segmented_single_chunk():
    # wchunk larger than the window: one scan per pass
    run_both("cold_snow", seed=12, wchunk=4096)


def test_coupled_skyview_oracle_parity():
    """Coupled + sky view vs the oracle: exercises
    the restore-time SW/LW coefficient choice with sky view active
    (src/Coupling.f90:66-77 takes the LW branch regardless of SW>LW)."""
    model, raw, pts, cal, settings = build_case(
        "winter_mix", seed=18, sky_view=0.6, obs_shift=2.0, npoints=3)
    _, out = model.run_coupled(raw, pts, cal)
    jax_out = np.asarray(out)

    oracle = Oracle(settings, PhysicsParams())
    for pnt in range(3):
        f = {k: np.array(getattr(raw, k)[pnt], np.float64)
             for k in ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw",
                       "sw_dir", "lw_net", "tsurf_obs")}
        f["prec_phase"] = np.array(raw.prec_phase[pnt])
        opt = OraclePoint(
            lat=float(pts.lat[pnt]), lon=float(pts.lon[pnt]),
            sky_view=float(pts.sky_view[pnt]),
            horizons=np.asarray(pts.horizons[pnt]),
            init_len=int(pts.init_len[pnt]),
            tair_relax=float(pts.tair_relax[pnt]),
            vz_relax=float(pts.vz_relax[pnt]),
            rh_relax=float(pts.rh_relax[pnt]),
            coupling_index=int(pts.coupling_end[pnt]),
            coupling_tsurf=float(pts.coupling_tsurf[pnt]),
        )
        ref = oracle.run(f, cal, opt)
        np.testing.assert_allclose(jax_out[:, pnt, :], ref, rtol=1e-9,
                                   atol=1e-9, err_msg=f"point {pnt}")
