"""CPU baseline: this repo's own XLA scan engine on the host CPU.

Measures the float32 scan engine (full physics, the same numerics as the
device path) on the multi-core host CPU backend at a production-shaped
workload -- the stand-in for a reference CPU node.  Per-core rates are
printed so other core counts can be scaled; run it on the host beside the
card to compare.

Usage: python tools/bench_cpu_baseline.py [--points 8192] [--steps 2961]
"""
import argparse
import json
import multiprocessing
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

os.environ.setdefault("XLA_FLAGS", "")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=2961)  # 1/3 of the 74h run
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model, scan_steps
    from roadsurf_tpu.state import default_point_params

    P, T = args.points, args.steps
    settings = ModelSettings(sim_len=T, dt=30.0)
    model = Model(settings)
    raw, cal = synthetic_raw(P, T, dt=30.0, seed=3, scenario="winter_mix",
                             dtype=np.float32)
    pts = default_point_params(P)
    prep = model.prepare(raw, pts, cal)
    state = model.init(raw, cal, dtype=jnp.float32)
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)

    fn = jax.jit(lambda st, pr: scan_steps(st, pr, ones, ones, obs,
                                           model.cfg, model.grid,
                                           model.params, collect=False))
    t0 = time.perf_counter()
    final, _ = fn(state, prep)
    jax.block_until_ready(final)
    compile_s = time.perf_counter() - t0
    best = None
    for _ in range(args.reps):
        t0 = time.perf_counter()
        final, _ = fn(state, prep)
        jax.block_until_ready(final)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
        print(f"  run: {dt:.2f}s = {P * T / dt / 1e6:.2f} M pt-steps/s",
              file=sys.stderr)
    ncores = multiprocessing.cpu_count()
    rate = P * T / best
    print(json.dumps({
        "metric": "cpu_scan_engine_point_steps_per_s",
        "value": round(rate, 1),
        "unit": "point-steps/s",
        "detail": {"points": P, "steps": T, "host_cores": ncores,
                   "per_core": round(rate / ncores, 1),
                   "compile_s": round(compile_s, 1), "dtype": "float32",
                   "wall_best_s": round(best, 2)},
    }))


if __name__ == "__main__":
    main()
