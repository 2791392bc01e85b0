"""Host data-plane ingest benchmark (round-1 review item 4).

Measures the file-backed stations -> RawForcing path that feeds the
production engine, at operational scale:

  parse+interp   example1 JSON parse + native batched interpolation to the
                 simulation grid (native/roadsurf_native.cpp, the
                 JsonSource.cpp:49-176 hot path) + overlay merge
  point mapping  nearest-station index for the full point grid
                 (RoadSurfSource.cpp:516-616 NearTree radius pattern)

The on-device expansion + prepare throughput is covered separately by
bench_production.py (it is fused into the kernel chunk dispatch).

Prints one JSON line:
  {"stations", "sim_len", "points", "parse_interp_s", "mapping_s",
   "station_values_per_s", "points_per_s"}

Usage: python tools/bench_ingest.py [--stations 2048] [--points 1048576]
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

# host-side ingest benchmark: force the CPU backend so per-call jax ops stay
# on the host
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=2048)
    ap.add_argument("--points", type=int, default=1048576)
    ap.add_argument("--analysis", type=int, default=48)
    ap.add_argument("--forecast", type=int, default=26)
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args(argv)

    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "gen_production", os.path.join(here, "gen_production.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)

    outdir = args.outdir or tempfile.mkdtemp(prefix="rs_ingest_")
    ny = int(round(args.points ** 0.5))
    nx = -(-args.points // ny)
    gen.main(["--outdir", outdir, "--stations", str(args.stations),
              "--ny", str(ny), "--nx", str(nx),
              "--analysis", str(args.analysis),
              "--forecast", str(args.forecast)])

    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.sources import DataHandler, read_json_tolerant
    from roadsurf_tpu.io import native
    from roadsurf_tpu.runner import build_times

    native.load(build_if_missing=True)
    config = read_json_tolerant(os.path.join(outdir, "config.json"))
    settings0 = ModelSettings.from_json(config)
    from roadsurf_tpu.runner import parse_forecast_time
    now = parse_forecast_time(config["time"]["now"]) \
        if config.get("time", {}).get("now") else None
    start, now, sim_len = build_times(config, now, settings0.dt)
    sim_epochs = start + (np.arange(sim_len)
                          * settings0.dt).astype(np.int64)

    t0 = time.perf_counter()
    handler = DataHandler.from_config(config, sim_epochs)
    raw_st, obs_tair = handler.merged(sim_len)
    t1 = time.perf_counter()
    parse_interp_s = t1 - t0
    S = len(handler.point_ids())
    assert np.asarray(raw_st.tair).shape == (S, sim_len)

    # full-grid nearest-station mapping
    from roadsurf_tpu.io.points import nearest_station_index, parse_points_full
    pset = parse_points_full(config)
    locs = handler.locations()
    st_lats = np.array([l[0] for l in locs])
    st_lons = np.array([l[1] for l in locs])
    t2 = time.perf_counter()
    st_idx = nearest_station_index(st_lats, st_lons, pset.lats, pset.lons,
                                   50.0)
    t3 = time.perf_counter()
    P = len(pset.lats)

    print(json.dumps({
        "stations": S, "sim_len": sim_len, "points": P,
        "parse_interp_s": round(parse_interp_s, 3),
        "mapping_s": round(t3 - t2, 3),
        "station_values_per_s": round(S * sim_len * 11 / parse_interp_s, 1),
        "points_per_s": round(P / (t3 - t2), 1),
        "native": native.load() is not None}))

    # ---- grid (querydata-equivalent) ingest at the same point count ------
    # directory merge (NFmiMultiQueryInfo view, QueryDataSource.cpp:62-66)
    # + bilinear extraction of every var at the full point set -- the host
    # side of the GridExpander build (the rest is device placement)
    grid_dir = os.path.join(outdir, "grids")
    R, gny, gnx = 25, 300, 400            # hourly NWP-ish national grid
    if not os.path.isdir(grid_dir):
        os.makedirs(grid_dir)
        rng = np.random.default_rng(5)
        glats = np.linspace(59.6, 70.1, gny)
        glons = np.linspace(20.5, 31.6, gnx)
        half = R // 2 + 2
        for fi, (lo, n) in enumerate([(0, half), (R - half, half)]):
            times = sim_epochs[0] + 3600 * (lo + np.arange(n, dtype=np.int64))
            shp = (n, gny, gnx)
            np.savez(os.path.join(grid_dir, f"run{fi}.npz"),
                     times=times, lats=glats, lons=glons,
                     tair=rng.normal(-3.0, 2.0, shp),
                     tdew=rng.normal(-5.0, 2.0, shp),
                     rhz=np.clip(rng.normal(85, 10, shp), 0, 100),
                     vz=np.abs(rng.normal(3, 1, shp)),
                     prec=np.abs(rng.normal(0, 0.5, shp)),
                     sw=np.abs(rng.normal(20, 10, shp)),
                     lw=rng.normal(290, 5, shp),
                     sw_dir=np.zeros(shp),
                     lw_net=rng.normal(-10, 2, shp),
                     tsurf_obs=rng.normal(-4, 2, shp),
                     prec_phase=rng.integers(0, 4, shp).astype(float))

    from roadsurf_tpu.io.gridsource import GridSource, bilinear_at_points
    t4 = time.perf_counter()
    src = GridSource({"path": grid_dir}, sim_epochs)
    t5 = time.perf_counter()
    nvals = 0
    for name, f in src.fields.items():
        v = bilinear_at_points(f, src.lats, src.lons, pset.lats, pset.lons)
        nvals += v.size
    t6 = time.perf_counter()
    print(json.dumps({
        "grid_files": 2, "grid_shape": [len(src.times), gny, gnx],
        "grid_load_merge_s": round(t5 - t4, 3),
        "bilinear_s": round(t6 - t5, 3),
        "bilinear_vals_per_s": round(nvals / (t6 - t5), 1),
        "points": P, "vars": len(src.fields)}))


if __name__ == "__main__":
    main()
