"""Production CLI benchmark: the full operational path, file-backed.

Generates (once) a nationwide-scale workload -- 2048 synthetic stations of
hourly weather in the example1 JSON format + a 1M-point grid config -- then
runs it through the real CLI runner with the streamed sharded Pallas engine
(`--engine pallas`): JSON data plane -> nearest-station index -> on-device
chunked expansion -> fused whole-scan kernel -> gridded npz output.

Needs a GPU: a run that finds none fails.  Prints one JSON line.  Env knobs:
BENCH_PROD_DIR (dataset cache dir), BENCH_PROD_NY/NX/STATIONS,
BENCH_PROD_CHUNK_T.
"""
from __future__ import annotations

import json
import os
import sys
import time


def main():
    import jax

    from bench import gpu_name_and_power
    from roadsurf_tpu import use_compile_cache

    use_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench_production.py measures the GPU; the backend is "
                 f"{jax.default_backend()!r}")
    card = gpu_name_and_power()
    grid_mode = os.environ.get("BENCH_PROD_MODE", "stations") == "grid"
    outdir = os.environ.get(
        "BENCH_PROD_DIR",
        "/tmp/roadsurf_prod_grid" if grid_mode else "/tmp/roadsurf_prod")
    ny = int(os.environ.get("BENCH_PROD_NY", 1024))
    nx = int(os.environ.get("BENCH_PROD_NX", 1024))
    stations = int(os.environ.get("BENCH_PROD_STATIONS", 2048))
    chunk_t = int(os.environ.get("BENCH_PROD_CHUNK_T", 64))

    log = lambda m: (print(m, file=sys.stderr), sys.stderr.flush())
    cfg_path = os.path.join(outdir, "config.json")
    # v2: even station-raster subsampling (the v1 tail truncation failed
    # 605 NE-corner points by construction)
    stamp = os.path.join(outdir,
                         f"gen_{stations}_{ny}_{nx}_v2.stamp")
    if not os.path.exists(stamp):
        log(f"generating workload in {outdir} ...")
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from tools.gen_production import main as gen_main
        t0 = time.perf_counter()
        gen_main(["--outdir", outdir, "--stations", str(stations),
                  "--ny", str(ny), "--nx", str(nx)]
                 + (["--grid-source"] if grid_mode else []))
        open(stamp, "w").write("ok")
        log(f"generated in {time.perf_counter() - t0:.1f}s")

    from roadsurf_tpu import runner
    from roadsurf_tpu.observability import RunMetrics

    metrics = RunMetrics()
    t0 = time.perf_counter()
    runner.run(cfg_path, None, engine="pallas",   # time from config "now"
               chunk_t=chunk_t, verbose=True, metrics=metrics)
    total = time.perf_counter() - t0

    rate = float(metrics.counters.get("point_steps_per_s", 0.0))
    npoints = int(metrics.counters.get("points", ny * nx))
    nsteps = int(metrics.counters.get("steps", 0))
    print(json.dumps({
        "metric": "production_cli_point_timesteps_per_s",
        "value": round(rate, 1),
        "unit": "point-steps/s",
        "detail": {
            "npoints": npoints, "steps": nsteps, "chunk_t": chunk_t,
            "stations": stations,
            "wall_s_total_cli": round(total, 2),
            "phases_s": {k: round(v, 2) for k, v in metrics.phases.items()},
            "card": card, "dtype": "float32",
            "forcing": ("file-backed NWP grid npz, on-device time interp"
                        if grid_mode else
                        "file-backed station JSON, on-device expansion")},
    }))


if __name__ == "__main__":
    main()
