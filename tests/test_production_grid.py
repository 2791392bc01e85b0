"""GridExpander: on-device gridded-NWP forcing expansion for the streamed
production engine (the QueryDataSource grid path,
examples/example2/src/QueryDataSource.cpp:585-722, re-designed as chunked
device interpolation).

Parity chain:
 1. GridExpander.window == GridSource.at_points sampled on the sim grid
    (bilinear + gap-capped interp + nearest phase + clamps + completion);
 2. run_production fed by a GridExpander == the XLA scan engine fed by the
    host-side at_points extraction;
 3. runner --engine pallas == --engine scan on a real grid config
    (incl. grid + station-obs overlay through CompositeExpander).
"""
import calendar
import json
import time as timelib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roadsurf_tpu import production, runner
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import Calendar, RawForcing
from roadsurf_tpu.io.gridsource import GridSource
from roadsurf_tpu.model import Model
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params

MISSING = -9999.9


def utc(s):
    return calendar.timegm(timelib.strptime(s, "%Y-%m-%d %H:%M"))


def _grid_fields(times, ny=3, nx=4, seed=3, with_gap=True,
                 missing_cells=True):
    """Synthetic NWP grid with awkward validity patterns: random missing
    cells, one all-missing sample, and (optionally) a >180-min hole."""
    rng = np.random.default_rng(seed)
    R = len(times)
    shp = (R, ny, nx)
    hr = np.arange(R)[:, None, None]
    fields = {
        "tair": -3.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "rhz": np.clip(85.0 + rng.normal(0, 30.0, shp), -20, 140),
        "vz": np.abs(rng.normal(3.0, 1.0, shp)),
        "prec": np.where(rng.random(shp) < 0.2,
                         rng.uniform(0, 150.0, shp), 0.0),
        "sw": np.abs(rng.normal(20.0, 10.0, shp)),
        "lw": 290.0 + rng.normal(0, 5.0, shp),
        "sw_dir": np.zeros(shp),
        "lw_net": -10.0 + rng.normal(0, 2.0, shp),
        "tsurf_obs": -4.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "prec_phase": rng.integers(0, 4, shp).astype(float),
    }
    if missing_cells:
        for name in ("tair", "rhz", "prec", "sw", "prec_phase"):
            m = rng.random(shp) < 0.15
            fields[name] = np.where(m, MISSING, fields[name])
        fields["tair"][2] = MISSING       # one all-missing sample
    return fields


def _make_times(t0, with_gap=True):
    """Hourly raw times with a 4-hour hole (gap cap = 180 min exercised)."""
    hours = [0, 1, 2, 3, 4, 8, 9, 10, 11, 12]
    if not with_gap:
        hours = list(range(10))
    return t0 + 3600 * np.array(hours, np.int64)


def _points(P, seed=5):
    rng = np.random.default_rng(seed)
    plat = 59.9 + rng.uniform(0, 1.3, P)      # a few outside the grid
    plon = 23.9 + rng.uniform(0, 1.8, P)
    return plat, plon


@pytest.mark.parametrize("chunk_t,dt", [(32, 300.0), (32, 1800.0)])
def test_grid_expander_window_matches_at_points(chunk_t, dt):
    t0 = utc("2019-12-02 00:00")
    times = _make_times(t0)
    ny, nx = 3, 4
    fields = _grid_fields(times, ny, nx)
    lats = np.linspace(60.0, 61.0, ny)
    lons = np.linspace(24.0, 25.5, nx)
    T = 97
    sim = t0 + (dt * np.arange(T)).astype(np.int64)

    P = 1024                                 # mesh x lane multiple
    plat, plon = _points(P)

    # host reference: the tested GridSource pipeline on the sim grid
    src = GridSource.__new__(GridSource)
    src.is_observation = False
    src.sim_times = sim
    src.times, src.lats, src.lons, src.fields = times, lats, lons, {
        k: np.asarray(v, np.float64) for k, v in fields.items()}
    ref = src.at_points(plat, plon)          # {name: [P, T]}

    mesh = make_mesh()
    exp = production.GridExpander(times, lats, lons, fields, plat, plon,
                                  sim, mesh, chunk_t=chunk_t)

    win_fn = jax.jit(lambda data, t0_: exp.window(data, t0_, chunk_t),
                     static_argnums=())
    for t0_c in [0, chunk_t, 3 * chunk_t, 17]:    # incl. a ragged offset
        got = win_fn(exp.device_data, np.int32(t0_c))
        n = min(chunk_t, T - t0_c)
        for name in RawForcing._fields:
            g = np.asarray(getattr(got, name))[:n]
            if name not in ref:
                assert np.all(g <= -9000.0), name
                continue
            want = np.asarray(ref[name])[:, t0_c:t0_c + n].T
            if name == "prec_phase":
                want = np.where(want <= -9000.0, -9999, want).astype(np.int64)
                np.testing.assert_array_equal(g, want, err_msg=name)
            else:
                both_missing = (want <= -9000.0) & (g <= -9000.0)
                np.testing.assert_allclose(
                    np.where(both_missing, 0.0, g),
                    np.where(both_missing, 0.0, want),
                    rtol=1e-4, atol=2e-3, err_msg=f"{name}@t0={t0_c}")


def test_grid_expander_first_host_matches_at_points():
    t0 = utc("2019-12-02 00:00")
    times = _make_times(t0)
    fields = _grid_fields(times)
    lats = np.linspace(60.0, 61.0, 3)
    lons = np.linspace(24.0, 25.5, 4)
    sim = t0 + 300 * np.arange(50, dtype=np.int64)
    P = 1024
    plat, plon = _points(P)
    src = GridSource.__new__(GridSource)
    src.is_observation = False
    src.sim_times = sim
    src.times, src.lats, src.lons, src.fields = times, lats, lons, {
        k: np.asarray(v, np.float64) for k, v in fields.items()}
    ref = src.at_points(plat, plon)
    exp = production.GridExpander(times, lats, lons, fields, plat, plon,
                                  sim, make_mesh(), chunk_t=32)
    for name in ("tair", "tdew", "rhz", "vz", "sw"):
        np.testing.assert_allclose(exp.first_host[name], ref[name][:, 0],
                                   atol=1e-9, err_msg=name)
    # host_at at a step subset
    sel = np.array([0, 7, 31])
    met = exp.host_at(sel)
    np.testing.assert_allclose(met["tair"], ref["tair"][:, sel], atol=1e-9)


def test_production_grid_matches_scan():
    """Streamed engine with on-device grid expansion == XLA scan engine fed
    the host-side at_points extraction."""
    t0 = utc("2019-12-02 00:00")
    times = _make_times(t0, with_gap=False)
    fields = _grid_fields(times, missing_cells=False)
    lats = np.linspace(60.0, 61.0, 3)
    lons = np.linspace(24.0, 25.5, 4)
    dt = 120.0
    T = 97
    sim = t0 + (dt * np.arange(T)).astype(np.int64)
    settings = ModelSettings(sim_len=T, dt=dt, use_relaxation=False)
    model = Model(settings)
    cal = Calendar.from_epochs(sim)

    P = 1000
    plat, plon = _points(P)
    plat = np.clip(plat, 60.0, 61.0)        # keep every point on the grid
    plon = np.clip(plon, 24.0, 25.5)

    src = GridSource.__new__(GridSource)
    src.is_observation = False
    src.sim_times = sim
    src.times, src.lats, src.lons, src.fields = times, lats, lons, {
        k: np.asarray(v, np.float64) for k, v in fields.items()}
    vals = src.at_points(plat, plon)
    raw_pt = RawForcing(**{
        n: (np.where(vals[n] <= -9000.0, -9999,
                     vals[n]).astype(np.int64) if n == "prec_phase"
            else vals[n].astype(np.float64))
        for n in RawForcing._fields if n in vals},
        **{n: (np.full((P, T), -9999, np.int64) if n == "prec_phase"
               else np.full((P, T), MISSING))
           for n in RawForcing._fields if n not in vals})

    pts = default_point_params(P)._replace(lat=plat, lon=plon)
    final_ref, out_ref = model.run(raw_pt, pts, cal)

    mesh = make_mesh()
    p_pad = production.padded_points(P, mesh)
    exp = production.GridExpander(
        times, lats, lons, fields,
        production._pad_tail(plat, p_pad), production._pad_tail(plon, p_pad),
        sim, mesh, chunk_t=32)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    res = production.run_production(model, exp, pts, cal, state0, mesh=mesh,
                                    chunk_t=32, out_stride=6)
    want_steps = np.arange(0, T, 6)
    assert np.array_equal(res.out_steps, want_steps)
    np.testing.assert_allclose(res.fields["tsurf"],
                               np.asarray(out_ref.tsurf)[want_steps],
                               rtol=2e-5, atol=5e-4)
    for name in ("wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(
            res.fields[name], np.asarray(getattr(out_ref, name))[want_steps],
            rtol=2e-5, atol=2e-3, err_msg=name)
    assert np.array_equal(np.asarray(res.state.failed),
                          np.asarray(final_ref.failed))


def test_production_grid_coupled_matches_scan():
    """Coupled run over grid forecast + station obs (the reference's
    operational mode: querydata forecast + obs coupling,
    examples/example2/src/roadrunner.cpp:763-792 + src/Coupling.f90:10-140)
    through run_production_coupled: phase B's window passes re-expand the
    forcing through the CompositeExpander(GridExpander, StationExpander) at
    non-aligned wchunk offsets -- compared against the scan coupled engine
    fed the host-side merged extraction."""
    from roadsurf_tpu.io.driver import derive_point_params
    from roadsurf_tpu.observability import RunMetrics

    t0 = utc("2019-12-02 00:00")
    times = _make_times(t0, with_gap=False)
    fields = _grid_fields(times, missing_cells=False)
    fields.pop("tsurf_obs")                  # obs come from the stations
    lats = np.linspace(60.0, 61.0, 3)
    lons = np.linspace(24.0, 25.5, 4)
    dt = 120.0
    T = 97
    sim = t0 + (dt * np.arange(T)).astype(np.int64)
    import dataclasses
    settings = ModelSettings(sim_len=T, dt=dt, use_relaxation=False,
                             use_coupling=True, coupling_minutes=60.0)
    model = Model(settings)
    cal = Calendar.from_epochs(sim)

    P = 1000
    plat, plon = _points(P)
    plat = np.clip(plat, 60.0, 61.0)
    plon = np.clip(plon, 24.0, 25.5)

    # station obs: tsurf only, valid every 30 min up to sim step 55; the
    # coupling window [26, 55] then straddles the 32-step chunk boundary
    S = 3
    rng = np.random.default_rng(9)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::83] = -1
    obs = np.full((S, T), MISSING)
    rows = np.arange(10, 56, 15)            # last valid obs at sim step 55
    obs[:, rows] = -5.0 + rng.normal(0, 0.8, (S, len(rows)))
    raw_st = RawForcing(**{
        n: (np.full((S, T), -9999, np.int64) if n == "prec_phase"
            else obs if n == "tsurf_obs"
            else np.full((S, T), MISSING))
        for n in RawForcing._fields})

    # host merged reference: grid forecast overlaid by the station obs
    src = GridSource.__new__(GridSource)
    src.is_observation = False
    src.sim_times = sim
    src.times, src.lats, src.lons, src.fields = times, lats, lons, {
        k: np.asarray(v, np.float64) for k, v in fields.items()}
    vals = src.at_points(plat, plon)
    ie = np.where(st_idx >= 0, st_idx, 0)
    obs_pt = np.where((st_idx >= 0)[:, None], obs[ie], MISSING)
    raw_pt = RawForcing(**{
        n: (np.where(vals[n] <= -9000.0, -9999,
                     vals[n]).astype(np.int64) if n == "prec_phase"
            else vals[n].astype(np.float64))
        for n in RawForcing._fields if n in vals},
        **{n: (np.full((P, T), -9999, np.int64) if n == "prec_phase"
               else obs_pt if n == "tsurf_obs"
               else np.full((P, T), MISSING))
           for n in RawForcing._fields if n not in vals})

    pts, blanked = derive_point_params(raw_pt, settings, lat=plat, lon=plon)
    pts = pts._replace(init_len=np.full(P, 16, np.int32))
    assert (np.asarray(pts.coupling_end)[st_idx >= 0] == 55).all()
    assert (np.asarray(pts.coupling_start)[st_idx >= 0] == 25).all()

    # scan engine on blanked obs (the runner's host path); production on
    # UNBLANKED obs -- prepare_window's window mask subsumes the blanking
    # (the production engines never materialize a blanked [P, T] series)
    raw_scan = raw_pt._replace(tsurf_obs=blanked)
    final_ref, out_pc = model.run_coupled(raw_scan, pts, cal, out_stride=6)
    out_pc = np.asarray(out_pc)

    mesh = make_mesh()
    p_pad = production.padded_points(P, mesh)
    pad = production._pad_tail
    gexp = production.GridExpander(
        times, lats, lons, fields, pad(plat, p_pad), pad(plon, p_pad),
        sim, mesh, chunk_t=32)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)
    sexp = production.StationExpander(raw_st, st_idx_pad, mesh, chunk_t=32)
    exp = production.CompositeExpander([gexp, sexp])

    state0 = model.init(raw_pt, cal, dtype=jnp.float32, pts=pts)
    metrics = RunMetrics()
    res = production.run_production_coupled(
        model, exp, pts, cal, state0, mesh=mesh, chunk_t=32, out_stride=6, metrics=metrics)
    assert metrics.counters.get("coupling_reruns", 0) >= 1

    want_steps = np.arange(0, T, 6)
    assert np.array_equal(res.out_steps, want_steps)
    names = ["tsurf", "wat", "snow", "ice", "ice2", "dep"]
    for fi, name in enumerate(names):
        np.testing.assert_allclose(
            res.fields[name], out_pc[:, :, fi], rtol=2e-4, atol=2e-3,
            err_msg=name)
    assert np.array_equal(np.asarray(res.state.failed),
                          np.asarray(final_ref.failed))


def test_last_valid_scan_matches_host():
    """production.last_valid_scan == host scan of the merged series (the
    device-side GetLatestObsIndex / latest-obs derivation for grid obs)."""
    t0 = utc("2019-12-02 00:00")
    times = _make_times(t0)
    fields = _grid_fields(times)
    lats = np.linspace(60.0, 61.0, 3)
    lons = np.linspace(24.0, 25.5, 4)
    dt = 300.0
    T = 97
    sim = t0 + (dt * np.arange(T)).astype(np.int64)
    P = 1024
    plat, plon = _points(P)
    src = GridSource.__new__(GridSource)
    src.is_observation = True
    src.sim_times = sim
    src.times, src.lats, src.lons, src.fields = times, lats, lons, {
        k: np.asarray(v, np.float64) for k, v in fields.items()}
    ref = src.at_points(plat, plon)
    mesh = make_mesh()
    exp = production.GridExpander(times, lats, lons, fields, plat, plon,
                                  sim, mesh, chunk_t=32)
    got = production.last_valid_scan(exp, mesh, T, chunk_t=32,
                                     names=("tsurf_obs", "tair"))
    for name in ("tsurf_obs", "tair"):
        series = np.asarray(ref[name])               # [P, T]
        valid = series > -100.0
        anyv = valid.any(axis=1)
        last = T - 1 - np.argmax(valid[:, ::-1], axis=1)
        idx, val = got[name]
        np.testing.assert_array_equal(idx, np.where(anyv, last, -1),
                                      err_msg=name)
        rows = np.arange(P)
        np.testing.assert_allclose(
            np.where(anyv, val, 0.0),
            np.where(anyv, series[rows, np.clip(last, 0, T - 1)], 0.0),
            rtol=1e-5, atol=1e-5, err_msg=name)


def _write_grid_npz(path, t0, nhours=7, ny=3, nx=4, tair_base=-3.0,
                    with_obs=False):
    lats = np.linspace(60.0, 61.0, ny)
    lons = np.linspace(24.0, 25.5, nx)
    times = t0 + 3600 * np.arange(nhours)
    shp = (nhours, ny, nx)
    lat_g = np.broadcast_to(lats[None, :, None], shp)
    hr = np.arange(nhours)[:, None, None]
    extra = {}
    if with_obs:
        extra["tsurf_obs"] = tair_base - 1.2 + 0.4 * hr + (lat_g - 60.0)
    np.savez(path, times=times, lats=lats, lons=lons,
             tair=tair_base + 0.5 * hr + (lat_g - 60.0),
             rhz=np.full(shp, 85.0), vz=np.full(shp, 3.0),
             prec=np.where(hr >= 3, 0.8, 0.0) * np.ones(shp),
             sw=np.full(shp, 20.0), lw=np.full(shp, 290.0),
             sw_dir=np.zeros(shp), lw_net=np.full(shp, -10.0),
             prec_phase=np.full(shp, 3.0), **extra)


def _runner_parity(cfg, tmp_path, tsurf_atol=5e-3):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    st_scan, f_scan = runner.run(str(cfg_path), verbose=False, engine="scan")
    st_pal, f_pal = runner.run(str(cfg_path), verbose=False, engine="pallas")
    steps = f_pal["steps"]
    assert steps[0] == 0 and len(steps) > 2
    np.testing.assert_allclose(f_pal["tsurf"], f_scan["tsurf"][steps],
                               rtol=1e-4, atol=tsurf_atol)
    for name in ("wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(f_pal[name], f_scan[name][steps],
                                   rtol=1e-4, atol=5e-3, err_msg=name)
    assert np.array_equal(np.asarray(st_pal.failed),
                          np.asarray(st_scan.failed))
    return st_pal, f_pal


def test_runner_grid_engine_parity(tmp_path):
    """A pure-grid example2-style config through --engine pallas == scan."""
    t0 = utc("2019-12-02 00:00")
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, t0, nhours=7)
    cfg = {
        "time": {"analysis": 2, "forecast": 4, "now": "20191202T0200"},
        "model": {"use_coupling": 0, "use_relaxation": 0, "DTSecs": 120.0},
        "output": {"step": 60},
        "points": {"grid": {"bbox": [60.0, 24.0, 61.0, 25.5],
                            "ny": 4, "nx": 5}},
        "input": [{"name": "FC", "path": str(fc), "type": "grid",
                   "source": "forecast"}],
    }
    _runner_parity(cfg, tmp_path)


def test_runner_grid_station_overlay_engine_parity(tmp_path):
    """Grid forecast + station obs overlay (CompositeExpander: grid part +
    station part, DataManager.cpp:67-77) through both engines."""
    t0 = utc("2019-12-02 00:00")
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, t0, nhours=7)
    ob = tmp_path / "obs.json"
    hours = [t0 + 3600 * k for k in range(3)]
    ob.write_text(json.dumps([{
        "statId": 1, "lat": 60.5, "lon": 24.75,
        "time": [timelib.strftime("%Y-%m-%d %H:%M", timelib.gmtime(h))
                 for h in hours],
        "Temperature 2m": [-6.0, -5.5, -5.0],
        "RoadTemperature": [-7.0, -6.5, -6.0]}]))
    cfg = {
        "time": {"analysis": 2, "forecast": 4, "now": "20191202T0200"},
        "model": {"use_coupling": 0, "use_relaxation": 1, "DTSecs": 120.0},
        "output": {"step": 60},
        "points": {"coordinates": [[60.5, 24.75], [60.9, 25.2],
                                   [60.2, 24.3], [60.7, 25.0]],
                   "max_radius_km": 30.0},
        "input": [
            {"name": "FC", "path": str(fc), "type": "grid",
             "source": "forecast"},
            {"name": "OBS", "path": str(ob), "type": "json",
             "source": "observations"},
        ],
    }
    _runner_parity(cfg, tmp_path)


def test_runner_grid_obs_coupling_engine_parity(tmp_path):
    """Grid OBSERVATION source (tsurf_obs + tair fields) driving coupling
    AND relaxation through the streamed engine == scan engine.  The
    per-point coupling window and relaxation anchor index are derived
    on device via production.last_valid_scan."""
    t0 = utc("2019-12-02 00:00")
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, t0, nhours=7)
    ob = tmp_path / "obs.npz"
    # obs grid: 3 hourly samples covering the 2 h analysis (last at now)
    _write_grid_npz(ob, t0, nhours=3, tair_base=-4.0, with_obs=True)
    cfg = {
        "time": {"analysis": 2, "forecast": 4, "now": "20191202T0200",
                 "coupling_minutes": 60},
        "model": {"use_coupling": 1, "use_relaxation": 1, "DTSecs": 120.0},
        "output": {"step": 60},
        "points": {"grid": {"bbox": [60.0, 24.0, 61.0, 25.5],
                            "ny": 4, "nx": 5}},
        "input": [
            {"name": "FC", "path": str(fc), "type": "grid",
             "source": "forecast"},
            {"name": "OBS", "path": str(ob), "type": "grid",
             "source": "observations"},
        ],
    }
    st_pal, f_pal = _runner_parity(cfg, tmp_path)
    assert not np.asarray(st_pal.failed).any()
