"""Benchmark: point-timesteps/s on one GPU at ~1M road points.

Times, in steady state after compilation, on the same 64-step forcing chunk:

  * ``scan``:   the plain XLA path, model.scan_steps (step.py under lax.scan);
  * ``kernel``: the fused Pallas kernel (ops.pallas_step.pallas_scan) on the
    SLIM tile-major forcing layout the production engine feeds it, once per
    block size in BENCH_BLOCKS;
  * ``fused_chunk``: the station production chunk (_Engine.chunk_fn: station
    prep gather + one-hot expansion + kernel in one jit);
  * ``grid_chunk``: the NWP-grid production chunk (device interpolation +
    per-point prep in the kernel layout + kernel).

Needs a GPU: a run that finds none fails.  Prints the device and its power
limit, then one JSON line.  Env knobs: BENCH_POINTS, BENCH_TCHUNK,
BENCH_CHUNKS, BENCH_BLOCKS (comma list).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def timed(fn, args, n: int) -> float:
    """Seconds per call of ``fn(*args)`` over n calls after one warm-up
    call (which compiles); every call ends in block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


def widened_chunk(model, npoints: int, t_chunk: int, seed: int = 0,
                  scenario: str = "winter_mix"):
    """(state [P] float32, prep [t_chunk, P] float32) for ``npoints`` points
    built on device from a 4,096-point synthetic seed tiled across the point
    axis (the physics has no data-dependent cost, so tiling is fair)."""
    import jax
    import jax.numpy as jnp

    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.state import default_point_params, init_state

    small = min(npoints, 4096)
    reps = -(-npoints // small)
    raw, cal = synthetic_raw(small, t_chunk, dt=30.0, seed=seed,
                             scenario=scenario, dtype=np.float32)
    prep_small = model.prepare(raw, default_point_params(small), cal)
    row0 = jnp.stack([jnp.asarray(np.asarray(x)[:, 0], np.float32)
                      for x in (raw.tair, raw.vz, raw.rhz, raw.tsurf_obs)])
    date0 = (int(cal.year[0]), int(cal.month[0]), int(cal.day[0]))

    @jax.jit
    def build(prep_small, row0):
        widen = lambda x: (jnp.tile(x, (1, reps))[:, :npoints]
                           if x.ndim == 2 else x)
        prep = jax.tree.map(widen, prep_small)
        wide0 = jnp.tile(row0, (1, reps))[:, :npoints]
        state = init_state(model.settings, model.params, model.grid,
                           wide0[0], wide0[1], wide0[2], wide0[3], date0,
                           depth_idx=model.cfg.depth_idx,
                           depth_w=model.cfg.depth_w,
                           use_depth=model.cfg.use_depth, dtype=jnp.float32)
        return prep, state

    prep, state = build(prep_small, row0)
    return state, prep


def slim_forcing(prep, obs, subl: int):
    """Prepared [T, P] channels -> the kernel's SLIM tile-major forcing
    [n_tiles, T, NCH_SLIM, subl, LANE], its [T] traffic-friction channel
    and the [4, P] aux rows (no coupling)."""
    import jax.numpy as jnp

    from roadsurf_tpu.ops import pallas_step as ps

    T, P = prep.tair.shape
    ones = jnp.ones((T, P), jnp.float32)
    full = ps.pack_forcing(prep, ones, ones, obs)          # [T, NCH, P]
    slim = full[:, list(ps.SLIM_CHANNELS)]
    tile_p = subl * ps.LANE
    slim = slim.reshape(T, ps.NCH_SLIM, P // tile_p, subl, ps.LANE)
    slim = jnp.transpose(slim, (2, 0, 1, 3, 4))
    zero = jnp.zeros((P,), jnp.float32)
    aux = jnp.stack([zero, zero, zero, jnp.asarray(obs, jnp.float32)])
    return slim, jnp.asarray(prep.trf_fric, jnp.float32), aux


def main():
    import jax
    import jax.numpy as jnp

    from roadsurf_tpu import production, use_compile_cache
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.forcing import Calendar
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model, scan_steps
    from roadsurf_tpu.ops import pallas_step as ps
    from roadsurf_tpu.parallel.sharding import make_mesh
    from roadsurf_tpu.state import default_point_params

    use_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; the backend is "
                 f"{jax.default_backend()!r}")
    card = gpu_name_and_power()
    print(f"device: {device_info()} | {card} | "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    npoints = int(os.environ.get("BENCH_POINTS", 1 << 20))
    t_chunk = int(os.environ.get("BENCH_TCHUNK", 64))
    n_chunks = int(os.environ.get("BENCH_CHUNKS", 4))
    blocks = [int(b) for b in
              os.environ.get("BENCH_BLOCKS", str(ps.BLOCK)).split(",")]
    assert npoints % ps.TILE_P == 0, npoints
    model = Model(ModelSettings(sim_len=t_chunk, dt=30.0))
    state, prep = widened_chunk(model, npoints, t_chunk)
    obs = jnp.full((npoints,), -9999.9, jnp.float32)
    rate = lambda sec: npoints * t_chunk / sec

    # ---- plain XLA path --------------------------------------------------
    @jax.jit
    def scan_chunk(state, prep, obs):
        ones = jnp.ones(prep.tair.shape, jnp.float32)
        return scan_steps(state, prep, ones, ones, obs, model.cfg,
                          model.grid, model.params, collect=False)[0]

    rates = {"scan": rate(timed(scan_chunk, (state, prep, obs), n_chunks))}

    # ---- fused kernel, slim tile-major forcing -------------------------
    tmp0, scal0 = ps.pack_state(state)
    forc, trf, aux = slim_forcing(prep, obs, ps.SUBL)
    block = ps.BLOCK
    for blk in blocks:
        ps.BLOCK = blk               # read when the kernel is traced
        kern = jax.jit(lambda t, s, f, r, a: ps.pallas_scan(
            t, s, f, model.cfg, model.params, model.grid,
            out_stride=t_chunk, slim_trf=r, aux_rows=a))
        rates[f"kernel_block{blk}"] = rate(
            timed(kern, (tmp0, scal0, forc, trf, aux), n_chunks))
    ps.BLOCK = block
    del forc

    # ---- fused station production chunk ----------------------------------
    S = 2048
    T2 = 8 * t_chunk + 1
    raw_st, cal2 = synthetic_raw(S, T2, dt=30.0, seed=7,
                                 scenario="winter_mix", dtype=np.float32)
    mesh = make_mesh()
    st_idx = np.random.default_rng(7).integers(0, S, size=npoints)
    settings2 = ModelSettings(sim_len=T2, dt=30.0, use_relaxation=False)
    model2 = Model(settings2)
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": settings2, "params": model2.params,
           "hour": cal2.hour, "t_total": T2}
    exp = production.StationExpander(raw_st, st_idx, mesh, chunk_t=t_chunk,
                                     prep_ctx=ctx)
    eng = production._Engine(model2, exp, default_point_params(npoints),
                             cal2, state, mesh=mesh, chunk_t=t_chunk)
    assert eng.fused
    fn = eng.chunk_fn(t_chunk, False)
    rates["fused_chunk"] = rate(timed(
        lambda: fn(eng.tmp0, eng.scal0, np.int32(t_chunk), eng.data), (),
        n_chunks))

    # ---- fused-generic NWP grid production chunk ---------------------------
    t0e = 1575158400
    sim_ep = t0e + (30.0 * np.arange(T2)).astype(np.int64)
    gt = t0e + 3600 * np.arange(1 + int(T2 * 30.0 // 3600) + 1,
                                dtype=np.int64)
    rng = np.random.default_rng(11)
    ny, nx = 300, 400
    gf = {n: rng.normal(0.0 if n in ("prec", "sw") else -3.0, 2.0,
                        (len(gt), ny, nx))
          for n in ("tair", "tdew", "rhz", "vz", "prec", "sw", "lw")}
    gf["rhz"] = np.abs(gf["rhz"]) + 60.0
    gf["vz"] = np.abs(gf["vz"]) + 1.0
    gf["prec"] = np.abs(gf["prec"])
    gf["sw"] = np.abs(gf["sw"])
    gf["lw"] = 280.0 + gf["lw"]
    gexp = production.GridExpander(
        gt, np.linspace(59.6, 70.1, ny), np.linspace(20.5, 31.6, nx), gf,
        rng.uniform(59.6, 70.1, npoints), rng.uniform(20.5, 31.6, npoints),
        sim_ep, mesh, chunk_t=t_chunk)
    geng = production._Engine(model2, gexp, default_point_params(npoints),
                              Calendar.from_epochs(sim_ep), state, mesh=mesh,
                              chunk_t=t_chunk)
    assert geng.fused_generic
    gfn = geng.chunk_fn(t_chunk, False)
    rates["grid_chunk"] = rate(timed(
        lambda: gfn(geng.tmp0, geng.scal0, np.int32(t_chunk), geng.data),
        (), n_chunks))

    print(json.dumps({
        "metric": "point_timesteps_per_s",
        "unit": "point-steps/s",
        "rates": {k: round(v, 1) for k, v in rates.items()},
        "detail": {"npoints": npoints, "t_chunk": t_chunk,
                   "n_chunks": n_chunks, "dtype": "float32",
                   "card": card, "device": device_info()},
    }))


if __name__ == "__main__":
    main()
