"""Fused-generic tile-major production path: the
operational grid / grid+station configurations ride the slim tile-major
kernel layout with the per-point forcing prep computed in kernel layout.

Parity chain:
 1. forcing.prepare_window(time_axis=1) on tile-major leaves == the flat
    [Tc, P] call, bitwise (same elementwise op sequence);
 2. GridExpander tiled interpolation == the flat layout, bitwise;
 3. StationExpander.window_tm (raw one-hot expansion) == window(), bitwise;
 4. run_production via the fused-generic engine == the generic per-point
    engine, for a pure grid config and a grid+station composite.
"""
import calendar
import time as timelib

import jax
import jax.numpy as jnp
import numpy as np

from roadsurf_tpu import production
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import Calendar, RawForcing, prepare_window
from roadsurf_tpu.model import Model
from roadsurf_tpu.ops import pallas_step as ps
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params

MISSING = -9999.9


def utc(s):
    return calendar.timegm(timelib.strptime(s, "%Y-%m-%d %H:%M"))


def _grid_case(with_missing=True, T=97, dt=120.0, ny=3, nx=4):
    t0 = utc("2019-12-02 00:00")
    hours = list(range(10))
    times = t0 + 3600 * np.array(hours, np.int64)
    rng = np.random.default_rng(3)
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
    if with_missing:
        for name in ("tair", "rhz", "prec", "sw", "prec_phase"):
            m = rng.random(shp) < 0.15
            fields[name] = np.where(m, MISSING, fields[name])
    lats = np.linspace(60.0, 61.0, ny)
    lons = np.linspace(24.0, 25.5, nx)
    sim = t0 + (dt * np.arange(T)).astype(np.int64)
    return times, lats, lons, fields, sim


def _points(P, seed=5, clip=True):
    rng = np.random.default_rng(seed)
    plat = 59.9 + rng.uniform(0, 1.3, P)
    plon = 23.9 + rng.uniform(0, 1.8, P)
    if clip:
        plat = np.clip(plat, 60.0, 61.0)
        plon = np.clip(plon, 24.0, 25.5)
    return plat, plon


def test_prepare_window_tile_major_matches_flat():
    """prepare_window(time_axis=1) on [nt, Tc, subl, LANE] leaves is bitwise
    the flat [Tc, P] computation (elementwise rules, layout-independent)."""
    rng = np.random.default_rng(11)
    Tc, P = 16, 512
    nt, subl = 2, 2            # 2 * 2 * 128 = 512
    T_total = 64
    t_off = 48                 # window 48..63 COVERS the lastValues row
                               # T_total-1 (its valid/clamp/relax masks key
                               # off the tb() broadcast under test)
    settings = ModelSettings(sim_len=T_total, dt=300.0, use_relaxation=True,
                             use_coupling=True)
    model = Model(settings)

    def rnd(lo, hi, miss_frac=0.1):
        v = rng.uniform(lo, hi, (Tc, P))
        v = np.where(rng.random((Tc, P)) < miss_frac, MISSING, v)
        return v

    rawT = RawForcing(
        tair=rnd(-20, 5), tdew=rnd(-25, 2), vz=rnd(0, 10), rhz=rnd(10, 100),
        prec=rnd(0, 5), sw=rnd(0, 300), lw=rnd(200, 350),
        sw_dir=rnd(0, 200), lw_net=rnd(-50, 30), tsurf_obs=rnd(-15, 5, 0.5),
        prec_phase=rng.integers(-1, 4, (Tc, P)))
    pts = default_point_params(P)._replace(
        init_len=rng.integers(1, 50, P).astype(np.int32),
        tair_relax=rng.uniform(-15, 5, P),
        vz_relax=rng.uniform(0, 8, P),
        rh_relax=rng.uniform(20, 100, P),
        coupling_start=rng.integers(1, 30, P).astype(np.int32),
        coupling_end=rng.integers(30, 60, P).astype(np.int32),
        coupling_tsurf=rng.uniform(-15, 5, P))
    anchors = tuple(rng.uniform(-10, 10, P) for _ in range(3))
    hour = rng.integers(0, 24, Tc)

    flat = prepare_window(rawT, pts, hour, settings, model.params,
                          t_offset=t_off, t_total=T_total, anchors=anchors)

    tm = lambda x: np.transpose(
        np.asarray(x).reshape(Tc, nt, subl, 128), (1, 0, 2, 3))
    ptm = lambda x: np.asarray(x).reshape(nt, subl, 128)
    rawTM = RawForcing(*(tm(getattr(rawT, n)) for n in RawForcing._fields))
    pts_tm = pts._replace(**{n: ptm(getattr(pts, n))
                             for n in pts._fields if n != "horizons"})
    tiled = prepare_window(rawTM, pts_tm, hour, settings, model.params,
                           t_offset=t_off, t_total=T_total,
                           anchors=tuple(ptm(a) for a in anchors),
                           time_axis=1)
    for n in ("tair", "vz", "rhz", "rain", "snow", "sw", "lw", "tsurf_obs",
              "valid", "in_coupling"):
        np.testing.assert_array_equal(
            tm(getattr(flat, n)), np.asarray(getattr(tiled, n)), err_msg=n)
    np.testing.assert_array_equal(np.asarray(flat.trf_fric),
                                  np.asarray(tiled.trf_fric))


def test_grid_window_tiled_matches_flat():
    """Tile-major GridExpander interpolation == the flat-layout storage
    (tile_p=100 is not a LANE multiple, forcing the flat path)."""
    times, lats, lons, fields, sim = _grid_case()
    P = 1024
    plat, plon = _points(P, clip=False)
    mesh = make_mesh()
    tiled = production.GridExpander(times, lats, lons, fields, plat, plon,
                                    sim, mesh, chunk_t=32)
    flat = production.GridExpander(times, lats, lons, fields, plat, plon,
                                   sim, mesh, chunk_t=32, tile_p=100)
    assert tiled.tile_geom is not None and flat.tile_geom is None
    wt = jax.jit(lambda d, t0: tiled.window(d, t0, 32))
    wf = jax.jit(lambda d, t0: flat.window(d, t0, 32))
    wtm = jax.jit(lambda d, t0: tiled.window_tm(d, t0, 32))
    nt, subl = tiled.tile_geom
    for t0 in [0, 32, 17, 64]:
        a = wt(tiled.device_data, np.int32(t0))
        b = wf(flat.device_data, np.int32(t0))
        c = wtm(tiled.device_data, np.int32(t0))
        for n in RawForcing._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, n)), np.asarray(getattr(b, n)),
                err_msg=f"{n}@t0={t0}")
            # window == window_tm transposed back to [tc, P]
            ctm = np.transpose(np.asarray(getattr(c, n)),
                               (1, 0, 2, 3)).reshape(32, P)
            np.testing.assert_array_equal(ctm, np.asarray(getattr(a, n)),
                                          err_msg=f"tm:{n}@t0={t0}")


def _station_case(P, T, S=7, seed=9):
    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::83] = -1
    mk = lambda lo, hi, mf=0.1: np.where(
        rng.random((S, T)) < mf, MISSING, rng.uniform(lo, hi, (S, T)))
    raw_st = RawForcing(
        tair=mk(-20, 5), tdew=mk(-25, 2), vz=mk(0, 10), rhz=mk(10, 100),
        prec=mk(0, 5), sw=mk(0, 300), lw=mk(200, 350), sw_dir=mk(0, 200),
        lw_net=mk(-50, 30), tsurf_obs=mk(-15, 5, 0.6),
        prec_phase=rng.integers(-1, 4, (S, T)))
    return raw_st, st_idx


def test_grid_device_extraction_matches_host():
    """Device-side spatial extraction (raw grids + host-computed float64
    cell geometry) == the host bilinear/nearest pipeline: continuous vars
    to float32 weight-rounding, prec_phase EXACTLY (the sorted-corner
    first-valid-wins tie-break replicates the host loop)."""
    times, lats, lons, fields, sim = _grid_case()
    # descending-latitude grid exercises the flip path of both extractors
    lats = lats[::-1].copy()
    fields = {k: np.asarray(v)[:, ::-1, :].copy() for k, v in fields.items()}
    P = 1024
    plat, plon = _points(P, clip=False)      # some points off-grid
    mesh = make_mesh()
    dev = production.GridExpander(times, lats, lons, fields, plat, plon,
                                  sim, mesh, chunk_t=32, extract="device")
    host = production.GridExpander(times, lats, lons, fields, plat, plon,
                                   sim, mesh, chunk_t=32, extract="host")
    wd = jax.jit(lambda d, t0: dev.window(d, t0, 32))
    wh = jax.jit(lambda d, t0: host.window(d, t0, 32))
    for t0 in [0, 32, 17]:
        a = wd(dev.device_data, np.int32(t0))
        b = wh(host.device_data, np.int32(t0))
        for n in RawForcing._fields:
            ga, gb = np.asarray(getattr(a, n)), np.asarray(getattr(b, n))
            if n == "prec_phase":
                np.testing.assert_array_equal(ga, gb, err_msg=f"{n}@{t0}")
                continue
            both_missing = (ga <= -9000.0) & (gb <= -9000.0)
            assert ((ga <= -9000.0) == (gb <= -9000.0)).all(), n
            np.testing.assert_allclose(
                np.where(both_missing, 0.0, ga),
                np.where(both_missing, 0.0, gb),
                rtol=1e-5, atol=1e-4, err_msg=f"{n}@t0={t0}")


def test_station_window_tm_matches_window():
    """Raw one-hot expansion == the row-gather expansion, bitwise
    (f32 HIGHEST selection), in the expander's sorted point order."""
    P, T = 1024, 97
    raw_st, st_idx = _station_case(P, T)
    mesh = make_mesh()
    exp = production.StationExpander(raw_st, st_idx, mesh, chunk_t=32,
                                     raw_tm=True)
    assert exp.point_perm is not None and exp.tile_geom is not None
    w = jax.jit(lambda d, t0: exp.window(d, t0, 32))
    wtm = jax.jit(lambda d, t0: exp.window_tm(d, t0, 32))
    for t0 in [0, 32, 17]:
        a = w(exp.device_data, np.int32(t0))
        c = wtm(exp.device_data, np.int32(t0))
        for n in RawForcing._fields:
            ctm = np.transpose(np.asarray(getattr(c, n)),
                               (1, 0, 2, 3)).reshape(32, P)
            want = np.asarray(getattr(a, n), ctm.dtype)
            np.testing.assert_array_equal(ctm, want,
                                          err_msg=f"{n}@t0={t0}")


def test_production_grid_fused_matches_generic():
    """run_production through the fused-generic tile-major engine ==
    the generic per-point engine (flat grid storage)."""
    times, lats, lons, fields, sim = _grid_case(with_missing=False)
    T = len(sim)
    dt = float(sim[1] - sim[0])
    settings = ModelSettings(sim_len=T, dt=dt, use_relaxation=False)
    model = Model(settings)
    cal = Calendar.from_epochs(sim)
    P = 1024
    plat, plon = _points(P)
    pts = default_point_params(P)._replace(lat=plat, lon=plon)
    mesh = make_mesh()

    first = None
    results = []
    for tile_p in (None, 100):     # tiled (fused-generic) vs flat (generic)
        exp = production.GridExpander(times, lats, lons, fields, plat, plon,
                                      sim, mesh, chunk_t=32, tile_p=tile_p)
        if first is None:
            first = {n: exp.first_host[n] for n in ("tair", "vz", "rhz",
                                                    "tsurf_obs")}
        raw0 = RawForcing(*(np.broadcast_to(
            np.asarray(first.get(n, np.full(P, MISSING)))[:, None],
            (P, T)) for n in RawForcing._fields))
        state0 = model.init(raw0, cal, dtype=jnp.float32)
        eng_probe = production._Engine(model, exp, pts, cal, state0,
                                       mesh=mesh, chunk_t=32)
        assert eng_probe.fused_generic == (tile_p is None)
        res = production.run_production(model, exp, pts, cal, state0,
                                        mesh=mesh, chunk_t=32, out_stride=6)
        results.append(res)
    fused, gen = results
    assert np.array_equal(fused.out_steps, gen.out_steps)
    for n in ("tsurf", "wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(fused.fields[n], gen.fields[n],
                                   rtol=1e-6, atol=1e-5, err_msg=n)
    np.testing.assert_array_equal(np.asarray(fused.state.failed),
                                  np.asarray(gen.state.failed))
    np.testing.assert_allclose(np.asarray(fused.state.tmp),
                               np.asarray(gen.state.tmp),
                               rtol=1e-6, atol=1e-5)


def test_production_skyview_fused_matches_generic():
    """Sky-view / local-horizon configs ride the fused-generic tile-major
    path (elementwise sun position + 360-way horizon select sweep in
    kernel layout) and must match the generic per-point engine."""
    T, dt = 97, 120.0
    t0 = utc("2019-12-02 00:00")
    sim = t0 + (dt * np.arange(T)).astype(np.int64)
    settings = ModelSettings(sim_len=T, dt=dt, use_relaxation=False)
    model = Model(settings)
    cal = Calendar.from_epochs(sim)
    P = 1024
    raw_st, st_idx = _station_case(P, T, seed=13)
    rng = np.random.default_rng(7)
    from roadsurf_tpu.state import default_point_params
    sky = np.full(P, 1.0)
    sky[::3] = 0.6
    hor = np.zeros((P, 360))
    hor[::3] = rng.uniform(0, 25, size=(np.sum(np.arange(P) % 3 == 0), 360))
    pts = default_point_params(P)._replace(
        lat=60.0 + rng.uniform(0, 1, P), lon=24.0 + rng.uniform(0, 2, P),
        sky_view=sky, horizons=hor)
    mesh = make_mesh()
    raw_pt = RawForcing(*(np.asarray(getattr(raw_st, n))
                          [np.where(st_idx >= 0, st_idx, 0)]
                          for n in RawForcing._fields))
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    results = []
    for fused_mode in (True, False):
        exp = production.StationExpander(raw_st, st_idx, mesh, chunk_t=32,
                                         raw_tm=fused_mode)
        eng_probe = production._Engine(model, exp, pts, cal, state0,
                                       mesh=mesh, chunk_t=32)
        assert eng_probe.enable_sky
        assert eng_probe.fused_generic == fused_mode
        assert not eng_probe.flat_horizons
        res = production.run_production(model, exp, pts, cal, state0,
                                        mesh=mesh, chunk_t=32, out_stride=6)
        results.append(res)
    fused, gen = results
    for n in ("tsurf", "wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(fused.fields[n], gen.fields[n],
                                   rtol=1e-6, atol=1e-5, err_msg=n)
    np.testing.assert_array_equal(np.asarray(fused.state.failed),
                                  np.asarray(gen.state.failed))


def test_production_composite_fused_matches_generic():
    """Grid forecast + station obs overlay through the fused-generic
    composite (raw-tm station part + shared-perm grid part) == the generic
    composite -- the reference's operational configuration
    (examples/example2/src/roadrunner.cpp:763-792) on the fast path."""
    times, lats, lons, fields, sim = _grid_case(with_missing=False)
    fields = dict(fields)
    fields.pop("tsurf_obs")
    T = len(sim)
    dt = float(sim[1] - sim[0])
    settings = ModelSettings(sim_len=T, dt=dt, use_relaxation=False)
    model = Model(settings)
    cal = Calendar.from_epochs(sim)
    P = 1024
    plat, plon = _points(P)
    pts = default_point_params(P)._replace(lat=plat, lon=plon)
    mesh = make_mesh()

    # station part carries obs + a patchy wind overlay
    raw_st, st_idx = _station_case(P, T)
    only = {"tsurf_obs", "vz"}
    raw_st = RawForcing(*((getattr(raw_st, n) if n in only
                           else np.full_like(np.asarray(getattr(raw_st, n)),
                                             -9999 if n == "prec_phase"
                                             else MISSING))
                          for n in RawForcing._fields))

    results = []
    for fused_mode in (True, False):
        sexp = production.StationExpander(raw_st, st_idx, mesh, chunk_t=32,
                                          raw_tm=fused_mode)
        perm = sexp.point_perm if fused_mode else None
        gexp = production.GridExpander(times, lats, lons, fields, plat, plon,
                                       sim, mesh, chunk_t=32,
                                       tile_p=None if fused_mode else 100,
                                       point_perm=perm)
        exp = production.CompositeExpander([gexp, sexp])
        assert (exp.tile_geom is not None) == fused_mode
        first = exp.first_host
        raw0 = RawForcing(*(np.broadcast_to(
            np.asarray(first[n])[:, None], (P, T))
            for n in RawForcing._fields))
        state0 = model.init(raw0, cal, dtype=jnp.float32)
        eng_probe = production._Engine(model, exp, pts, cal, state0,
                                       mesh=mesh, chunk_t=32)
        assert eng_probe.fused_generic == fused_mode
        res = production.run_production(model, exp, pts, cal, state0,
                                        mesh=mesh, chunk_t=32, out_stride=6)
        results.append(res)
    fused, gen = results
    assert np.array_equal(fused.out_steps, gen.out_steps)
    for n in ("tsurf", "wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(fused.fields[n], gen.fields[n],
                                   rtol=1e-6, atol=1e-5, err_msg=n)
    np.testing.assert_array_equal(np.asarray(fused.state.failed),
                                  np.asarray(gen.state.failed))
