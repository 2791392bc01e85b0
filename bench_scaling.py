"""Weak-scaling benchmark: point-steps/s vs device count over a points mesh.

BASELINE.md's scaling target is >=80% linear scaling of point-steps/s at 1M+
points.  Columns are independent, so the production kernel runs under
``shard_map`` with zero hot-loop collectives (parallel/sharding.py
``pallas_scan_sharded``); this harness measures throughput on 1, 2, 4, ...
up to every visible device, keeping points-per-device constant (weak
scaling -- the production regime: more cards -> more road network).

Needs GPUs: a run that finds none fails.  With one visible card the sweep
degenerates to the single-card measurement.  Prints one JSON line per device
count plus a final summary line with the parallel efficiency of the largest
mesh vs one device.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from bench import gpu_name_and_power
    from roadsurf_tpu import use_compile_cache
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.ops import pallas_step as ps
    from roadsurf_tpu.parallel.sharding import (POINTS, make_mesh,
                                                pallas_scan_sharded)
    from roadsurf_tpu.state import default_point_params

    use_compile_cache()
    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"bench_scaling.py measures GPUs; the backend is "
                 f"{backend!r}")
    print(f"card: {gpu_name_and_power()}")
    per_device = int(os.environ.get("BENCH_POINTS_PER_DEVICE", 1 << 20))
    t_chunk = int(os.environ.get("BENCH_TCHUNK", 64))
    n_chunks = int(os.environ.get("BENCH_CHUNKS", 4))
    devices = jax.devices()

    settings = ModelSettings(sim_len=t_chunk, dt=30.0)
    model = Model(settings)

    # One small seed block, widened PER DEVICE under shard_map: each device
    # tiles its own [.., per_device] shard from the replicated seed, so no
    # global forcing tensor is ever materialized on one card.
    small = min(per_device, 4096)
    assert per_device % small == 0, (per_device, small)
    raw, cal = synthetic_raw(small, t_chunk, dt=30.0, seed=0,
                             dtype=np.float32)
    pts = default_point_params(small)
    prep_small = model.prepare(raw, pts, cal)
    state_small = model.init(raw, cal, dtype=jnp.float32)
    ones_small = jnp.ones((t_chunk, small), jnp.float32)
    obs_small = jnp.full((small,), -9999.9, jnp.float32)
    tmp_small, scal_small = ps.pack_state(state_small)
    forc_small = ps.pack_forcing(prep_small, ones_small, ones_small,
                                 obs_small)
    reps = per_device // small

    def measure(ndev):
        mesh = make_mesh(devices[:ndev])
        npoints = per_device * ndev

        def widen_local(t, s, f):
            # runs once per device: tile the seed block to this shard only
            return (jnp.tile(t, (1, reps)), jnp.tile(s, (1, reps)),
                    jnp.tile(f, (1, 1, reps)))

        build = jax.jit(jax.shard_map(
            widen_local, mesh=mesh,
            in_specs=(P(None, None), P(None, None), P(None, None, None)),
            out_specs=(P(None, POINTS), P(None, POINTS),
                       P(None, None, POINTS))))
        tmp0, scal0, forc = build(tmp_small, scal_small, forc_small)
        jax.block_until_ready(forc)

        run = jax.jit(lambda t, s, f: pallas_scan_sharded(
            t, s, f, model.cfg, model.params, model.grid, mesh,
            out_stride=t_chunk))
        r = run(tmp0, scal0, forc)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            r = run(tmp0, scal0, forc)
        jax.block_until_ready(r)
        dt = time.perf_counter() - t0
        return npoints, npoints * t_chunk * n_chunks / dt

    results = []
    ndev = 1
    sizes = []
    while ndev <= len(devices):
        sizes.append(ndev)
        ndev *= 2
    if sizes[-1] != len(devices):
        sizes.append(len(devices))     # always measure the full mesh
    for ndev in sizes:
        npoints, rate = measure(ndev)
        results.append((ndev, rate))
        print(json.dumps({"devices": ndev, "points": npoints,
                          "rate_Mpts": round(rate / 1e6, 1)}))

    r1 = results[0][1]
    nd, rn = results[-1]
    eff = rn / (nd * r1) if nd > 1 else 1.0
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": round(eff, 3),
        "unit": "fraction of linear",
        "vs_baseline": round(eff / 0.80, 3),
        "detail": {"devices": nd, "backend": backend,
                   "per_device_points": per_device,
                   "rates_Mpts": {str(d): round(r / 1e6, 1)
                                  for d, r in results}},
    }))


if __name__ == "__main__":
    main()
