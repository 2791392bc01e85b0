"""Coupled-mode production benchmark on the GPU.

Measures run_production_coupled at operational scale: the streamed Pallas
kernel carries phases A/C while the coupling window (src/Coupling.f90) runs
as the iteration-major masked-scan engine in one device dispatch.  Scenarios:

  typical  obs offset ~1 K from the free trajectory -> secant converges in a
           few window re-runs (the operational case)
  worst    obs offset -30 K, unreachable -> every coupled point burns the
           full 25-iteration budget (Coupling.f90:318-330 failure path)

Prints one JSON line per scenario:
  {"scenario", "points", "steps", "window_steps", "reruns",
   "point_steps_per_s", "wall_s", "uncoupled_point_steps_per_s",
   "coupled_overhead_pct"}

Usage: python tools/bench_coupled.py [--points 262144] [--steps 8881]
         [--stations 2048] [--window-steps 360] [--scenario typical|worst|both]
"""
import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=8881)
    ap.add_argument("--stations", type=int, default=2048)
    ap.add_argument("--window-steps", type=int, default=360)
    ap.add_argument("--end-step", type=int, default=None,
                    help="1-based coupling end step (default: 24h analysis)")
    ap.add_argument("--scenario",
                    choices=("typical", "hard", "worst", "both"),
                    default="both")
    ap.add_argument("--chunk-t", type=int, default=0,
                    help="0 = auto-size for the point count")
    ap.add_argument("--fast", action="store_true",
                    help="station-level prepared channels + fused one-hot "
                         "expansion (phases A/C fused incl. the in-kernel "
                         "cof decay)")
    ap.add_argument("--grid", action="store_true",
                    help="grid NWP forecast + station obs composite (the "
                         "reference's operational coupled mode: phase-B "
                         "window passes re-expand through the "
                         "CompositeExpander(GridExpander, StationExpander))")
    ap.add_argument("--grid-ny", type=int, default=300)
    ap.add_argument("--grid-nx", type=int, default=400)
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from roadsurf_tpu import production
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.observability import RunMetrics
    from roadsurf_tpu.parallel.sharding import make_mesh
    from roadsurf_tpu.state import default_point_params

    P, T, S = args.points, args.steps, args.stations
    dt = 30.0
    end_i = args.end_step or (1 + int(24 * 3600 / dt))   # 24h analysis end
    start_i = max(1, end_i - args.window_steps + 1)
    settings = ModelSettings(sim_len=T, dt=dt, use_coupling=True,
                             output_step_minutes=60)
    model = Model(settings)

    rng = np.random.default_rng(7)
    raw_st, cal = synthetic_raw(S, T, dt=dt, seed=7, scenario="winter_mix",
                                dtype=np.float32)
    st_idx = rng.integers(0, S, size=P)

    mesh = make_mesh()
    p_pad = production.padded_points(P, mesh)
    chunk_t = args.chunk_t or production.auto_chunk_t(p_pad)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)

    # per-point params; obs target near the station tair at the window end
    # (station-derived, so the --fast prepared-channel contract holds)
    tair_end_st = np.asarray(raw_st.tair)[:, end_i - 1]
    tair_end = tair_end_st[st_idx]
    base_pts = default_point_params(P)

    def pts_for(offset):
        return base_pts._replace(
            lat=58.0 + rng.uniform(0, 6, P), lon=20.0 + rng.uniform(0, 10, P),
            coupling_start=np.full(P, start_i, np.int32),
            coupling_end=np.full(P, end_i, np.int32),
            coupling_tsurf=(tair_end + offset).astype(np.float64))

    # first-step per-point values for init_state, captured BEFORE --grid
    # blanks the station channels down to obs-only
    first_vals = {n: np.asarray(getattr(raw_st, n))[st_idx, 0]
                  .astype(np.float32)
                  for n in ("tair", "vz", "rhz", "tsurf_obs")}

    grid_part = None
    if args.grid:
        # NWP forecast grid covering the points; the stations contribute
        # ONLY tsurf_obs (the coupled operational stack,
        # examples/example2/src/roadrunner.cpp:763-792)
        t0e = 1575158400
        sim_ep = t0e + (dt * np.arange(T)).astype(np.int64)
        gtimes = t0e + 3600 * np.arange(1 + int(T * dt // 3600) + 1,
                                        dtype=np.int64)
        ny, nx = args.grid_ny, args.grid_nx
        glats = np.linspace(59.6, 70.1, ny)
        glons = np.linspace(20.5, 31.6, nx)
        R = len(gtimes)
        gfields = {n: rng.normal(0.0 if n in ("prec", "sw") else -3.0, 2.0,
                                 (R, ny, nx))
                   for n in ("tair", "tdew", "rhz", "vz", "prec", "sw",
                             "lw")}
        gfields["rhz"] = np.abs(gfields["rhz"]) + 60.0
        gfields["vz"] = np.abs(gfields["vz"]) + 1.0
        gfields["prec"] = np.abs(gfields["prec"])
        gfields["sw"] = np.abs(gfields["sw"])
        gfields["lw"] = 280.0 + gfields["lw"]
        gfields["prec_phase"] = rng.integers(0, 4, (R, ny, nx)).astype(float)
        plat = rng.uniform(59.6, 70.1, p_pad)
        plon = rng.uniform(20.5, 31.6, p_pad)
        # station part carries obs only; raw_tm enables the fused-generic
        # tile-major composite (the round-5 operational fast path)
        miss = np.full_like(np.asarray(raw_st.tair), -9999.9)
        obs_only = raw_st._replace(**{
            n: (np.full_like(np.asarray(raw_st.prec_phase), -9999)
                if n == "prec_phase" else miss)
            for n in raw_st._fields if n != "tsurf_obs"})
        raw_st = obs_only
        st_part_g = production.StationExpander(raw_st, st_idx_pad, mesh,
                                               chunk_t=chunk_t, raw_tm=True)
        t0b = time.perf_counter()
        grid_part = production.GridExpander(
            gtimes, glats, glons, gfields, plat, plon, sim_ep, mesh,
            chunk_t=chunk_t, point_perm=st_part_g.point_perm,
            tile_p=(st_part_g._fused_plan["tile_p"]
                    if st_part_g.point_perm is not None else None))
        print(f"GridExpander build: {time.perf_counter()-t0b:.1f}s "
              f"(fused={st_part_g.point_perm is not None})", file=sys.stderr)

    def expander_for(offset):
        """--fast bakes the (scenario-specific) station obs + coupling
        window into the prepared channels, so each scenario rebuilds."""
        if args.grid:
            return production.CompositeExpander([grid_part, st_part_g])
        if not args.fast:
            return production.StationExpander(raw_st, st_idx_pad, mesh,
                                              chunk_t=chunk_t)
        st_pts1 = default_point_params(S + 1)._replace(
            coupling_start=np.concatenate(
                [np.full(S, start_i, np.int32), [-99]]).astype(np.int32),
            coupling_end=np.concatenate(
                [np.full(S, end_i, np.int32), [-99]]).astype(np.int32),
            coupling_tsurf=np.concatenate(
                [tair_end_st + offset, [-9999.9]])
            if offset is not None else
            np.concatenate([np.full(S, -9999.9), [-9999.9]]))
        ctx = {"st_pts": st_pts1, "anchors": None, "settings": settings,
               "params": model.params, "hour": cal.hour, "t_total": T}
        return production.StationExpander(raw_st, st_idx_pad, mesh,
                                          chunk_t=chunk_t, prep_ctx=ctx)

    def first(name):
        return first_vals[name]

    from roadsurf_tpu.state import init_state
    date0 = (int(cal.year[0]), int(cal.month[0]), int(cal.day[0]))
    state0 = jax.jit(lambda t0, v0, r0, o0: init_state(
        settings, model.params, model.grid, t0, v0, r0, o0, date0,
        depth_idx=model.cfg.depth_idx, depth_w=model.cfg.depth_w,
        use_depth=model.cfg.use_depth, dtype=jnp.float32))(
            first("tair"), first("vz"), first("rhz"), first("tsurf_obs"))

    def run(fn, pts, label, offset=None):
        expander = expander_for(offset)
        best = None
        reruns = 0
        for r in range(args.repeat):
            m = RunMetrics()
            res = fn(model, expander, pts, cal, state0, mesh=mesh,
                     chunk_t=chunk_t, metrics=m)
            reruns = m.counters.get("coupling_reruns", 0)
            if best is None or res.point_steps_per_s > best:
                best = res.point_steps_per_s
            print(f"  {label} run {r}: {res.point_steps_per_s/1e6:.1f} M "
                  f"pt-steps/s (reruns={reruns})", file=sys.stderr)
        return best, reruns

    # uncoupled baseline at the same shape
    unc_rate, _ = run(production.run_production, pts_for(0.0)._replace(
        coupling_tsurf=np.full(P, -9999.9)), "uncoupled", offset=None)

    scenarios = {"typical": -1.5, "hard": 8.0, "worst": -30.0}
    if args.scenario != "both":
        scenarios = {args.scenario: scenarios[args.scenario]}
    for name, offset in scenarios.items():
        rate, reruns = run(production.run_production_coupled,
                           pts_for(offset), name, offset=offset)
        print(json.dumps({
            "scenario": name, "fast": bool(args.fast),
            "grid": bool(args.grid),
            "points": P, "steps": T,
            "window_steps": end_i - start_i + 1, "reruns": int(reruns),
            "point_steps_per_s": round(rate, 1),
            "wall_s": round(P * T / rate, 3),
            "uncoupled_point_steps_per_s": round(unc_rate, 1),
            "coupled_overhead_pct": round(100.0 * (unc_rate / rate - 1.0),
                                          1)}))


if __name__ == "__main__":
    main()
