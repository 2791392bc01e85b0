"""Generate a production-scale, file-backed workload for the CLI runner.

Produces an example1-format station forecast JSON (hourly weather for S
synthetic stations over a Finland-like bounding box) plus a runner config in
grid point mode (ny x nx simulation points, nearest-station forcing) -- the
nationwide rolling-forecast workload (SURVEY.md section 6: 1M+ points,
48 h analysis + 26 h forecast at 30 s).

    python tools/gen_production.py --outdir /tmp/prod \
        --stations 2048 --ny 1024 --nx 1024

Then:

    python -m roadsurf_tpu.runner -c /tmp/prod/config.json \
        -t 20191202T0000 --engine pallas
"""
from __future__ import annotations

import argparse
import json
import os
import time as timelib

import numpy as np

BBOX = (59.6, 20.5, 70.1, 31.6)     # lat1, lon1, lat2, lon2


def station_weather(rng, hours, lat, lon, phase):
    """Synthetic but physically plausible hourly winter weather."""
    h = np.arange(hours + 1, dtype=np.float64)
    hod = h % 24.0
    base = -2.0 + 6.0 * (lat.mean() if hasattr(lat, "mean") else 0.0) * 0.0
    diurnal = np.cos((hod - 14.0) / 24.0 * 2 * np.pi)
    tair = (base + 4.0 * diurnal + 0.6 * np.sin(h / 7.0 + phase)
            + rng.normal(0, 0.3, h.shape))
    rh = np.clip(82.0 + 12.0 * np.sin(h / 5.0 + phase)
                 + rng.normal(0, 2.0, h.shape), 45.0, 100.0)
    vz = np.clip(3.5 + 2.0 * np.sin(h / 9.0 + 2 * phase)
                 + rng.normal(0, 0.4, h.shape), 0.2, 18.0)
    elev = (np.sin(np.radians(lat)) * -0.404
            + np.cos(np.radians(lat))
            * np.cos(np.radians(15.0 * (hod - 12.0) + lon - 25.0)) * 0.915)
    sw = np.clip(900.0 * elev, 0.0, None)
    lw = np.clip(285.0 + 2.2 * tair + 10.0 * np.sin(h / 11.0 + phase),
                 150.0, 420.0)
    prec = np.where(np.sin(h / 4.0 + 3 * phase) > 0.8,
                    rng.gamma(2.0, 0.4, h.shape), 0.0)
    return tair, rh, vz, np.clip(prec, 0, 8), sw, lw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--stations", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--analysis", type=int, default=48)
    ap.add_argument("--forecast", type=int, default=26)
    ap.add_argument("--start", default="2019-12-01 00:00",
                    help="data start (UTC); run -t must be start+analysis")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--output-step-min", type=int, default=360)
    ap.add_argument("--grid-source", action="store_true",
                    help="NWP grid npz forcing (querydata-equivalent) "
                         "instead of station JSON -- the example2 run_grid "
                         "mode (roadrunner.cpp:763-771)")
    ap.add_argument("--grid-src-ny", type=int, default=300)
    ap.add_argument("--grid-src-nx", type=int, default=400)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    hours = args.analysis + args.forecast
    import calendar as callib
    t0 = callib.timegm(timelib.strptime(args.start, "%Y-%m-%d %H:%M"))
    epochs = t0 + 3600 * np.arange(hours + 1)
    times = [timelib.strftime("%Y-%m-%d %H:%M", timelib.gmtime(int(e)))
             for e in epochs]

    lat1, lon1, lat2, lon2 = BBOX
    # quasi-uniform station scatter covering the box (grid + jitter) so every
    # grid point has a station within the default 50 km radius
    side = int(np.ceil(np.sqrt(args.stations)))
    gy, gx = np.meshgrid(np.linspace(lat1, lat2, side),
                         np.linspace(lon1, lon2, side), indexing="ij")
    # drop the surplus raster cells EVENLY (spacing > 1 keeps the indices
    # distinct): a tail truncation left the last ~68 cells -- the NE corner
    # -- without stations, failing 605 points by construction
    sel = np.linspace(0, side * side - 1, args.stations).astype(np.int64)
    lats = (gy + rng.uniform(-0.02, 0.02, gy.shape)).ravel()[sel]
    lons = (gx + rng.uniform(-0.04, 0.04, gx.shape)).ravel()[sel]

    if args.grid_source:
        # one smooth NWP field set [R, ny, nx] (hourly): spatial gradients +
        # the same diurnal/synoptic structure as the station generator
        gy_s = np.linspace(lat1, lat2, args.grid_src_ny)
        gx_s = np.linspace(lon1, lon2, args.grid_src_nx)
        LA, LO = np.meshgrid(gy_s, gx_s, indexing="ij")
        h = np.arange(hours + 1, dtype=np.float64)[:, None, None]
        hod = h % 24.0
        diurnal = np.cos((hod - 14.0) / 24.0 * 2 * np.pi)
        north = (LA - lat1) / (lat2 - lat1)
        tair = (-2.0 - 6.0 * north + 4.0 * diurnal
                + 0.6 * np.sin(h / 7.0 + 3.0 * LO / (lon2 - lon1))
                + rng.normal(0, 0.2, (hours + 1, 1, 1)))
        rhz = np.clip(80.0 + 10.0 * np.sin(h / 5.0 + 2 * north)
                      + rng.normal(0, 1.5, (hours + 1, 1, 1)), 45.0, 100.0)
        vz = np.clip(3.0 + 2.0 * np.sin(h / 9.0 + LO) + north
                     + rng.normal(0, 0.3, (hours + 1, 1, 1)), 0.2, 18.0)
        prec = np.where(np.sin(h / 11.0 + 4 * LO) > 0.8,
                        np.abs(rng.normal(0.6, 0.3, (hours + 1, 1, 1))), 0.0)
        elev = np.maximum(
            0.0, np.sin((hod - 12.0) / 24.0 * 2 * np.pi + 0.4) - 0.75)
        sw = 420.0 * elev * (1.0 - 0.3 * north)
        lw = 255.0 + 25.0 * np.sin(h / 13.0) + 5.0 * north
        fields = {"tair": tair, "rhz": rhz, "vz": vz, "prec": prec,
                  "sw": sw + 0.0 * LA, "lw": lw + 0.0 * LA}
        gpath = os.path.join(args.outdir, "nwp_grid.npz")
        np.savez(gpath, times=epochs, lats=gy_s, lons=gx_s,
                 **{k: np.asarray(v, np.float32) for k, v in fields.items()})
        run_t = timelib.strftime("%Y%m%dT%H%M",
                                 timelib.gmtime(t0 + 3600 * args.analysis))
        config = {
            "time": {"analysis": args.analysis, "forecast": args.forecast,
                     "now": run_t},
            "model": {"use_coupling": 0, "use_relaxation": 0, "DTSecs": 30,
                      "NLayers": 15},
            "parameters": {},
            "points": {"grid": {"bbox": [lat1, lon1, lat2, lon2],
                                "ny": args.ny, "nx": args.nx}},
            "output": {"step": args.output_step_min,
                       "filename": os.path.join(args.outdir,
                                                "forecast_out.npz")},
            "missing_limit": 100,
            "input": [{"type": "grid", "path": gpath}],
        }
        cpath = os.path.join(args.outdir, "config.json")
        with open(cpath, "w") as f:
            json.dump(config, f, indent=1)
        print(json.dumps({"config": cpath, "grid": gpath,
                          "points": args.ny * args.nx,
                          "grid_shape": [hours + 1, args.grid_src_ny,
                                         args.grid_src_nx],
                          "run_t": run_t}))
        return

    doc = []
    for sid in range(args.stations):
        phase = float(rng.uniform(0, 2 * np.pi))
        tair, rh, vz, prec, sw, lw = station_weather(
            rng, hours, lats[sid], lons[sid], phase)
        r3 = lambda a: [round(float(v), 3) for v in a]
        doc.append({
            "statId": 1000 + sid,
            "lat": round(float(lats[sid]), 4),
            "lon": round(float(lons[sid]), 4),
            "time": times,
            "Temperature 2m": r3(tair), "Humidity": r3(rh),
            "WindSpeed": r3(vz), "Precipitation": r3(prec),
            "RadiationGlobal": r3(sw), "RadiationLW": r3(lw),
        })
    fpath = os.path.join(args.outdir, "forecast.json")
    with open(fpath, "w") as f:
        json.dump(doc, f)

    run_t = timelib.strftime("%Y%m%dT%H%M",
                             timelib.gmtime(t0 + 3600 * args.analysis))
    config = {
        "time": {"analysis": args.analysis, "forecast": args.forecast,
                 "now": run_t},
        "model": {"use_coupling": 0, "use_relaxation": 0, "DTSecs": 30,
                  "NLayers": 15},
        "parameters": {},
        "points": {"grid": {"bbox": [lat1, lon1, lat2, lon2],
                            "ny": args.ny, "nx": args.nx}},
        "output": {"step": args.output_step_min,
                   "filename": os.path.join(args.outdir, "forecast_out.npz")},
        "missing_limit": 100,
        "input": [{"type": "json", "source": "forecasts", "path": fpath}],
    }
    cpath = os.path.join(args.outdir, "config.json")
    with open(cpath, "w") as f:
        json.dump(config, f, indent=1)
    print(json.dumps({"config": cpath, "forecast": fpath,
                      "points": args.ny * args.nx,
                      "stations": args.stations, "run_t": run_t}))


if __name__ == "__main__":
    main()
