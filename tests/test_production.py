"""Production streamed engine parity: the chunked on-device expansion +
prepare_window + sharded Pallas pipeline must reproduce the XLA scan engine
(float32 vs float32; kernel in interpret mode on CPU, 8 virtual devices)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roadsurf_tpu import production
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import RawForcing, relax_anchors
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model, scan_steps
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params


def _station_setup(S=5, P=1000, T=97, seed=11, use_relaxation=True,
                   skyview=True):
    settings = ModelSettings(sim_len=T, dt=30.0,
                             use_relaxation=use_relaxation)
    model = Model(settings)
    raw_st, cal = synthetic_raw(S, T, seed=seed, dtype=np.float32)

    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::97] = -1                      # a few out-of-radius points

    # host-side reference expansion (what the expander does on device)
    def expand(x, fill):
        v = np.asarray(x)[np.where(st_idx >= 0, st_idx, 0)]
        return np.where((st_idx >= 0)[:, None], v, fill)

    raw_pt = RawForcing(
        *(expand(getattr(raw_st, n), -9999 if n == "prec_phase"
                 else np.float32(-9999.9)) for n in RawForcing._fields))

    pts = default_point_params(P)
    pts = pts._replace(
        lat=58.0 + rng.uniform(0, 6, P), lon=20.0 + rng.uniform(0, 10, P))
    if skyview:
        sky = np.full(P, 1.0)
        sky[::3] = 0.6
        hor = np.zeros((P, 360))
        hor[::3] = rng.uniform(0, 20, size=360)
        pts = pts._replace(sky_view=sky, horizons=hor)
    if use_relaxation:
        il = np.full(P, 25, np.int32)
        rows = np.arange(P)
        pts = pts._replace(
            init_len=il,
            tair_relax=np.asarray(raw_pt.tair)[rows, il] + 0.4,
            vz_relax=np.asarray(raw_pt.vz)[rows, il] + 0.1,
            rh_relax=np.asarray(raw_pt.rhz)[rows, il] - 2.0)
    return settings, model, raw_st, raw_pt, cal, pts, st_idx


def _reference_run(model, raw_pt, cal, pts):
    final, out = model.run(raw_pt, pts, cal)
    return final, out


@pytest.mark.parametrize("chunk_t,out_stride", [
    (32, 6), (32, 1),
    # ragged chunk grid: 97 = 6 full 16-step chunks + a 1-step tail, output
    # stride that divides neither the chunk nor T (the chunk-boundary /
    # out-stride interplay beyond aligned shapes)
    (16, 7),
])
def test_production_matches_scan(chunk_t, out_stride):
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup()
    T = settings.sim_len
    final_ref, out_ref = _reference_run(model, raw_pt, cal, pts)

    mesh = make_mesh()
    p_pad = production.padded_points(len(st_idx), mesh)
    st_idx_pad = np.pad(st_idx, (0, p_pad - len(st_idx)),
                        constant_values=-1)
    exp = production.StationExpander(raw_st, st_idx_pad, mesh,
                                     chunk_t=chunk_t)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    res = production.run_production(
        model, exp, pts, cal, state0,
        anchors=relax_anchors(raw_pt, pts),
        mesh=mesh, chunk_t=chunk_t, out_stride=out_stride)

    want_steps = np.arange(0, T, out_stride)
    assert np.array_equal(res.out_steps, want_steps)
    np.testing.assert_allclose(
        res.fields["tsurf"], np.asarray(out_ref.tsurf)[want_steps],
        rtol=2e-5, atol=2e-4)
    for name in ("wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(
            res.fields[name], np.asarray(getattr(out_ref, name))[want_steps],
            rtol=2e-5, atol=2e-3, err_msg=name)
    np.testing.assert_allclose(np.asarray(res.state.tmp),
                               np.asarray(final_ref.tmp),
                               rtol=2e-5, atol=2e-4)
    assert np.array_equal(np.asarray(res.state.failed),
                          np.asarray(final_ref.failed))


def _station_prep_ctx(settings, model, raw_st, cal, pts, st_idx,
                      virtual_init_len=None):
    """Station-rank prep_ctx mirroring a per-point params construction where
    every per-point value is st_pts[st_idx] (the fast-path contract)."""
    S = np.asarray(raw_st.tair).shape[0]
    rows = np.arange(S)
    il_st = np.full(S, int(np.asarray(pts.init_len)[0]), np.int32)
    raw_np = {n: np.asarray(getattr(raw_st, n)) for n in
              ("tair", "vz", "rhz")}
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    if settings.use_relaxation:
        il = il_st[0]
        st_pts1 = default_point_params(S + 1)._replace(
            init_len=app(il_st, il_st[0]).astype(np.int32),
            tair_relax=app(raw_np["tair"][rows, il] + 0.4, -9999.9),
            vz_relax=app(raw_np["vz"][rows, il] + 0.1, -9999.9),
            rh_relax=app(raw_np["rhz"][rows, il] - 2.0, -9999.9))
        vz_a = raw_np["vz"].copy()
        vz_a[:, 0] = np.maximum(vz_a[:, 0], 0.4)
        anch1 = (app(raw_np["tair"][rows, il - 1], -9999.9),
                 app(vz_a[rows, il - 1], -9999.9),
                 app(raw_np["rhz"][rows, il - 1], -9999.9))
    else:
        st_pts1 = default_point_params(S + 1)._replace(
            init_len=np.full(S + 1, int(np.asarray(pts.init_len)[0]),
                             np.int32))
        anch1 = None
    cs = np.asarray(pts.coupling_start)
    st_pts1 = st_pts1._replace(
        coupling_start=app(np.full(S, cs[0], np.int32), -99).astype(np.int32),
        coupling_end=app(np.full(S, np.asarray(pts.coupling_end)[0],
                                 np.int32), -99).astype(np.int32))
    return {"st_pts": st_pts1, "anchors": anch1, "settings": settings,
            "params": model.params, "hour": cal.hour,
            "t_total": settings.sim_len}


def test_production_fast_prep_matches():
    """The station-level prepared-channel fast path must reproduce the
    generic per-point prepare path (same engine, prep_ctx on vs off)."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup(
        skyview=False)
    mesh = make_mesh()
    P = len(st_idx)
    p_pad = production.padded_points(P, mesh)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)
    ctx = _station_prep_ctx(settings, model, raw_st, cal, pts, st_idx)

    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    anchors = relax_anchors(raw_pt, pts)
    runs = {}
    for label, prep_ctx in (("generic", None), ("fast", ctx)):
        exp = production.StationExpander(raw_st, st_idx_pad, mesh,
                                         chunk_t=32, prep_ctx=prep_ctx)
        if label == "fast":
            assert exp.prep_data is not None
        runs[label] = production.run_production(
            model, exp, pts, cal, state0, anchors=anchors, mesh=mesh,
            chunk_t=32, out_stride=6)
    for name in runs["fast"].fields:
        np.testing.assert_allclose(
            runs["fast"].fields[name], runs["generic"].fields[name],
            rtol=2e-6, atol=2e-6, err_msg=name)
    np.testing.assert_allclose(np.asarray(runs["fast"].state.tmp),
                               np.asarray(runs["generic"].state.tmp),
                               rtol=2e-6, atol=2e-6)
    assert np.array_equal(np.asarray(runs["fast"].state.failed),
                          np.asarray(runs["generic"].state.failed))


def test_production_coupled_fast_prep_matches():
    """Fast prepared channels through the coupled driver: phases A/C use the
    fast chunk fns (incl. the with_cofs variant), phase B the generic window
    engine -- must equal the generic-expander coupled run."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _coupled_setup()
    P = len(st_idx)
    # station-derived obs (the fast-path contract): per-point obs equals its
    # station's obs; station 2 carries no obs at all
    rng = np.random.default_rng(5)
    S = np.asarray(raw_st.tair).shape[0]
    obs_st = np.asarray(raw_st.tair)[:, 39] - rng.uniform(0.5, 2.5, S)
    obs_st[2] = -9999.9
    obs_pt = np.where(st_idx >= 0, obs_st[np.where(st_idx >= 0, st_idx, 0)],
                      -9999.9)
    pts = pts._replace(coupling_tsurf=obs_pt)

    mesh = make_mesh()
    p_pad = production.padded_points(P, mesh)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)
    ctx = _station_prep_ctx(settings, model, raw_st, cal, pts, st_idx)
    ctx["st_pts"] = ctx["st_pts"]._replace(
        coupling_tsurf=np.concatenate([obs_st, [-9999.9]]))

    state0 = model.init(raw_pt, cal, dtype=jnp.float32, pts=pts)
    runs = {}
    for label, prep_ctx in (("generic", None), ("fast", ctx)):
        exp = production.StationExpander(raw_st, st_idx_pad, mesh,
                                         chunk_t=32, prep_ctx=prep_ctx)
        runs[label] = production.run_production_coupled(
            model, exp, pts, cal, state0, mesh=mesh, chunk_t=32,
            out_stride=6)
    for name in runs["fast"].fields:
        np.testing.assert_allclose(
            runs["fast"].fields[name], runs["generic"].fields[name],
            rtol=2e-6, atol=2e-6, err_msg=name)
    assert np.array_equal(np.asarray(runs["fast"].state.failed),
                          np.asarray(runs["generic"].state.failed))


def test_runner_engine_parity(tmp_path):
    """runner --engine pallas must reproduce --engine scan on a real config
    with file-backed forcing (example1 stations, example2 grid point mode)."""
    import importlib.util
    import json
    import os

    ex1 = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "example1")
    spec = importlib.util.spec_from_file_location("ex1_gen",
                                                  os.path.join(ex1, "make_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.main(["--stations", "3", "--analysis", "2", "--forecast", "2",
              "--outdir", str(tmp_path)])

    from roadsurf_tpu.io.sources import read_json_tolerant
    cfg = read_json_tolerant(os.path.join(ex1, "example_config.json"))
    cfg["time"]["analysis"] = 1
    cfg["time"]["forecast"] = 1
    cfg["model"]["use_coupling"] = 0
    cfg["model"]["DTSecs"] = 120
    cfg["points"] = {"grid": {"bbox": [60.1, 24.8, 61.0, 26.1],
                              "ny": 4, "nx": 5}}
    for src in cfg["input"]:
        src["path"] = str(tmp_path / os.path.basename(src["path"]))
    cfg["parameters"].pop("sky_view_file", None)
    cfg["parameters"].pop("local_horizon_file", None)
    del cfg["output"]["filename"]
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))

    from roadsurf_tpu import runner
    st_scan, f_scan = runner.run(str(cfg_path), "20191202T0000",
                                 verbose=False, engine="scan")
    st_pal, f_pal = runner.run(str(cfg_path), "20191202T0000",
                               verbose=False, engine="pallas")
    steps = f_pal["steps"]
    assert steps[0] == 0 and len(steps) > 2
    # scan runs float64 on CPU, the production engine float32
    np.testing.assert_allclose(f_pal["tsurf"], f_scan["tsurf"][steps],
                               rtol=1e-4, atol=5e-3)
    for name in ("wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(f_pal[name], f_scan[name][steps],
                                   rtol=1e-4, atol=5e-3, err_msg=name)
    assert np.array_equal(np.asarray(st_pal.failed),
                          np.asarray(st_scan.failed))


def test_production_rejects_per_point_depth():
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup(
        P=200, T=32, use_relaxation=False, skyview=False)
    pts = pts._replace(out_depth=np.full(200, 0.05))
    mesh = make_mesh()
    p_pad = production.padded_points(200, mesh)
    exp = production.StationExpander(
        raw_st, np.pad(st_idx, (0, p_pad - 200), constant_values=-1),
        mesh, chunk_t=32)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    with pytest.raises(ValueError, match="out_depth"):
        production.run_production(model, exp, pts, cal, state0, mesh=mesh,
                                  chunk_t=32)


def _coupled_setup(S=5, P=640, T=97, seed=23):
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup(
        S=S, P=P, T=T, seed=seed, use_relaxation=False, skyview=False)
    import dataclasses
    settings = dataclasses.replace(settings, use_coupling=True)
    model = Model(settings)
    # per-point coupling window [11, 40] with an offset obs target so the
    # control iterates; every 7th point has no obs (never coupled)
    rng = np.random.default_rng(seed)
    obs = np.asarray(raw_pt.tair)[:, 39] - rng.uniform(0.5, 2.5, P)
    obs[::7] = -9999.9
    pts = pts._replace(
        coupling_start=np.full(P, 11, np.int32),
        coupling_end=np.full(P, 40, np.int32),
        coupling_tsurf=obs)
    return settings, model, raw_st, raw_pt, cal, pts, st_idx


@pytest.mark.parametrize("out_stride", [1, 6])
def test_production_coupled_matches_pc(out_stride):
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _coupled_setup()
    T = settings.sim_len
    final_pc, out_pc = model.run_coupled(raw_pt, pts, cal,
                                         out_stride=out_stride)
    out_pc = np.asarray(out_pc)                    # [n_out, P, 6] float32

    mesh = make_mesh()
    p_pad = production.padded_points(len(st_idx), mesh)
    st_idx_pad = np.pad(st_idx, (0, p_pad - len(st_idx)),
                        constant_values=-1)
    exp = production.StationExpander(raw_st, st_idx_pad, mesh, chunk_t=32)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32, pts=pts)
    res = production.run_production_coupled(
        model, exp, pts, cal, state0, mesh=mesh, chunk_t=32,
        out_stride=out_stride)

    want_steps = np.arange(0, T, out_stride)
    assert np.array_equal(res.out_steps, want_steps)
    names = ["tsurf", "wat", "snow", "ice", "ice2", "dep"]
    for fi, name in enumerate(names):
        np.testing.assert_allclose(
            res.fields[name], out_pc[:, :, fi], rtol=2e-4, atol=2e-3,
            err_msg=name)
    assert np.array_equal(np.asarray(res.state.failed),
                          np.asarray(final_pc.failed))


def test_production_coupled_no_window_falls_back():
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _coupled_setup()
    pts = pts._replace(coupling_tsurf=np.full(len(st_idx), -9999.9))
    mesh = make_mesh()
    p_pad = production.padded_points(len(st_idx), mesh)
    exp = production.StationExpander(
        raw_st, np.pad(st_idx, (0, p_pad - len(st_idx)),
                       constant_values=-1), mesh, chunk_t=32)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32, pts=pts)
    res = production.run_production_coupled(
        model, exp, pts, cal, state0, mesh=mesh, chunk_t=32,
        out_stride=6)
    res_unc = production.run_production(
        model, exp, pts, cal, state0, mesh=mesh, chunk_t=32,
        out_stride=6)
    for name in res.fields:
        np.testing.assert_array_equal(res.fields[name],
                                      res_unc.fields[name], err_msg=name)


def test_production_warm_start_cycle(tmp_path):
    """Rolling forecast cycle through the streamed engine: checkpoint_out ->
    checkpoint_in across two CLI runs, parity vs the scan engine's warm
    start (the RoadSurfSource rolling-cycle mechanism,
    examples/example2/src/RoadSurfSource.cpp:516-616, done as state
    checkpoints)."""
    import json

    import test_io
    from roadsurf_tpu import runner

    fc, ob, t0 = test_io._write_full_inputs(tmp_path)
    out1 = tmp_path / "o1.json"
    cfgp = test_io._write_config(tmp_path, fc, ob, out1)

    ck_s = tmp_path / "ck_scan.npz"
    ck_p = tmp_path / "ck_pal.npz"
    runner.run(str(cfgp), checkpoint_out=str(ck_s), verbose=False,
               engine="scan")
    runner.run(str(cfgp), checkpoint_out=str(ck_p), verbose=False,
               engine="pallas")
    zs, zp = np.load(ck_s), np.load(ck_p)
    assert list(zs["point_ids"]) == list(zp["point_ids"])
    np.testing.assert_allclose(zp["tmp"], zs["tmp"], rtol=1e-4, atol=5e-3)

    # cycle 2: warm-started from cycle 1's checkpoint, both engines
    st_s, f_s = runner.run(str(cfgp), checkpoint_in=str(ck_s),
                           verbose=False, engine="scan")
    st_p, f_p = runner.run(str(cfgp), checkpoint_in=str(ck_p),
                           verbose=False, engine="pallas")
    steps = f_p["steps"]
    np.testing.assert_allclose(f_p["tsurf"], f_s["tsurf"][steps],
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(np.asarray(st_p.tmp), np.asarray(st_s.tmp),
                               rtol=1e-4, atol=5e-3)
    # and the warm start actually changed the early trajectory
    st_c, f_c = runner.run(str(cfgp), verbose=False, engine="pallas")
    assert not np.allclose(f_p["tsurf"][0], f_c["tsurf"][0])
