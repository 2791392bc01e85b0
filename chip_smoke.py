#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU, compiled, at nationwide
width (1,048,576 road points).

    python chip_smoke.py               # one card: phases b, a, c-g below
    python chip_smoke.py --four-cards  # four cards: the sharded engine only

Phases (one process; the card tests run first, in a child process, before
this process starts a JAX backend -- two JAX processes cannot share one
card's memory):

  b. ``pytest -m gpu`` in a child process.
  a. platform, device kind and count, XLA_FLAGS and the card's name and
     power limit; fails unless the platform is ``gpu``.
  c. kernel parity at real width: the compiled fused kernel against the plain
     XLA reference (model.scan_steps), both running free over 2,880 steps
     (24 h) streamed in 64-step chunks of device-built forcing; the state
     after every chunk and the hourly outputs must stay within the repo's
     tolerance (rtol 2e-5, atol 2e-4 K / 2e-3 mm) at every point, and no
     temperature may differ by more than 0.05 K; the point-major,
     tile-major and slim layouts must agree bitwise.
  d. the CLI path end to end: tools/gen_production.py data (2,048 stations,
     1024 x 1024 grid points) through ``runner.run(engine="auto")`` for the
     full 8,881 steps.
  e. the operational example2 stack: NWP grid + station obs, coupled,
     through production.run_production_coupled.
  f. per-point sky view with horizons: a few streamed chunks.
  g. the one-hot Precision.HIGHEST station expansion equals the row gather
     bit for bit.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase exits non-zero before it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
P_REAL = 1 << 20          # points of the nationwide deployment
CHUNK = 64                # streaming chunk (production.auto_chunk_t at 1M)


class PhaseFailed(Exception):
    pass


def fail(msg: str):
    raise PhaseFailed(msg)


def abort(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        abort(f"nvidia-smi unavailable ({e}): no GPU here")
    if out.returncode != 0 or not out.stdout.strip():
        abort(f"nvidia-smi found no GPU: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Phases:
    """Runs phases one after another, timing each; a phase that fails is
    reported and the next one still runs."""

    def __init__(self):
        self.times = {}
        self.failed = []

    def run(self, name, fn, *args, **kw):
        log(f"--- phase {name}")
        t0 = time.perf_counter()
        try:
            fn(*args, **kw)
        except Exception as e:                 # noqa: BLE001 -- reported
            import traceback
            traceback.print_exc()
            self.failed.append(f"{name}: {type(e).__name__}: {e}")
            log(f"--- phase {name}: FAILED")
        else:
            log(f"--- phase {name}: {time.perf_counter() - t0:.1f} s")
        self.times[name] = time.perf_counter() - t0


def run_gpu_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", "tests/"], cwd=REPO, env=env, timeout=900)
    if r.returncode != 0:
        fail(f"pytest -m gpu exited {r.returncode}")


def count_cache_events() -> dict:
    """Live counts of JAX's persistent compile-cache lookups."""
    import jax
    names = {"/jax/compilation_cache/cache_hits": "hits",
             "/jax/compilation_cache/cache_misses": "misses"}
    counts = {"hits": 0, "misses": 0}

    def listener(event, **_):
        if event in names:
            counts[names[event]] += 1
    jax.monitoring.register_event_listener(listener)
    return counts


def stats(a, b, atol, rtol):
    """(max |a-b|, 99.9th percentile |a-b|, points outside atol+rtol|b|)
    over [rows, P] or [P] device arrays."""
    import jax.numpy as jnp
    d = jnp.abs(a - b)
    bad = d > atol + rtol * jnp.abs(b)
    if d.ndim > 1:
        bad = bad.any(axis=0)
        dp = d.max(axis=0)
    else:
        dp = d
    return (float(d.max()), float(jnp.percentile(dp, 99.9)),
            int(bad.sum()))


def phase_parity(n_points: int, t_total: int):
    """Compiled kernel vs model.scan_steps at real width (phase c)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import slim_forcing
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model, scan_steps
    from roadsurf_tpu.ops import pallas_step as ps
    from roadsurf_tpu.state import default_point_params, init_state

    stride = 120                               # hourly at 30 s
    subl = min(ps.SUBL, n_points // ps.LANE)   # fused-expansion tile rows
    model = Model(ModelSettings(sim_len=t_total, dt=30.0))
    small = min(4096, n_points)
    reps = n_points // small
    raw, cal = synthetic_raw(small, t_total, dt=30.0, seed=3,
                             scenario="winter_mix", dtype=np.float32)
    prep_small = model.prepare(raw, default_point_params(small), cal)
    prep_small = jax.tree.map(
        lambda x: (jnp.asarray(x, jnp.float32)
                   if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
                   else jnp.asarray(x)), prep_small)
    row0 = np.stack([np.asarray(x)[:, 0] for x in
                     (raw.tair, raw.vz, raw.rhz, raw.tsurf_obs)])
    date0 = (int(cal.year[0]), int(cal.month[0]), int(cal.day[0]))

    @jax.jit
    def init(row0):
        w = jnp.tile(jnp.asarray(row0, jnp.float32), (1, reps))
        return init_state(model.settings, model.params, model.grid,
                          w[0], w[1], w[2], w[3], date0,
                          depth_idx=model.cfg.depth_idx,
                          depth_w=model.cfg.depth_w,
                          use_depth=model.cfg.use_depth, dtype=jnp.float32)

    # the seed travels as a jit argument (a closed-over array would be
    # baked into the program as a constant)
    def widen(seed, t0):
        sl = lambda x: (jax.lax.dynamic_slice_in_dim(x, t0, CHUNK)
                        if x.ndim == 1 else
                        jnp.tile(jax.lax.dynamic_slice_in_dim(x, t0, CHUNK),
                                 (1, reps)))
        return jax.tree.map(sl, seed)

    @jax.jit
    def ref_chunk(state, seed, t0):
        prep = widen(seed, t0)
        obs = jnp.full((n_points,), -9999.9, jnp.float32)
        ones = jnp.ones(prep.tair.shape, jnp.float32)
        final, out = scan_steps(state, prep, ones, ones, obs, model.cfg,
                                model.grid, model.params)
        k = (-t0) % stride                     # first output row, if any
        rows = jnp.stack([jax.lax.dynamic_index_in_dim(
            getattr(out, n), jnp.minimum(k, CHUNK - 1), keepdims=False)
            for n in ("tsurf", "wat", "snow", "ice", "ice2", "dep")])
        return final, rows

    def kern(tmp, scal, forc, t0, **kw):
        return ps.pallas_scan(tmp, scal, forc, model.cfg, model.params,
                              model.grid, out_stride=stride, out_offset=t0,
                              n_out=1, **kw)

    @jax.jit
    def kernel_chunk(tmp, scal, seed, t0):
        prep = widen(seed, t0)
        obs = jnp.full((n_points,), -9999.9, jnp.float32)
        forc, _, aux = slim_forcing(prep, obs, subl)
        # the kernel reads the time-only channel at the GLOBAL step
        return kern(tmp, scal, forc, t0, slim_trf=seed.trf_fric,
                    aux_rows=aux)

    @jax.jit
    def layouts_chunk(tmp, scal, seed, t0):
        prep = widen(seed, t0)
        obs = jnp.full((n_points,), -9999.9, jnp.float32)
        ones = jnp.ones(prep.tair.shape, jnp.float32)
        full = ps.pack_forcing(prep, ones, ones, obs)      # [T, NCH, P]
        tm = jnp.transpose(
            full.reshape(CHUNK, ps.NCH, -1, subl, ps.LANE),
            (2, 0, 1, 3, 4))
        return kern(tmp, scal, full, t0), kern(tmp, scal, tm, t0)

    @jax.jit
    def packed(state):
        return ps.pack_state(state)

    def compare(worst, got, rows, state, ref_rows, hit):
        """Accumulate per field: max |diff|, 99.9th percentile, the most
        points outside the repo tolerance at one check, and the most values
        that differ bitwise."""
        checks = [("tmp", got.tmp.T, state.tmp.T, 2e-4),
                  ("tsurf", got.tsurf_ave, state.tsurf_ave, 2e-4)]
        checks += [(n, getattr(got, n), getattr(state, n), 2e-3)
                   for n in ("wat", "snow", "ice", "ice2", "dep")]
        if hit:
            checks += [(f"out_{n}", rows[k], ref_rows[k],
                        2e-4 if k == 0 else 2e-3)
                       for k, n in enumerate(("tsurf", "wat", "snow", "ice",
                                              "ice2", "dep"))]
        for name, a, b, atol in checks:
            mx, p999, nbad = stats(a, b, atol, 2e-5)
            ndiff = int(jnp.sum(a != b))
            w = worst.setdefault(name, [0.0, 0.0, 0, 0])
            w[:] = (max(w[0], mx), max(w[1], p999), max(w[2], nbad),
                    max(w[3], ndiff))

    # the kernel runs free for 24 h, as in production, beside the
    # reference; the point-major and tile-major layouts rerun every chunk
    # from the kernel's own state and must equal the slim one bitwise
    state = init(row0)
    tmp, scal = packed(state)
    worst = {}
    layout_diff = ""
    for t0 in range(0, t_total, CHUNK):
        t0_ = np.int32(t0)
        hit = (-t0) % stride < CHUNK           # an output row was written
        pm, tm = layouts_chunk(tmp, scal, prep_small, t0_)
        tmp, scal, out = kernel_chunk(tmp, scal, prep_small, t0_)
        state, ref_rows = ref_chunk(state, prep_small, t0_)
        for name, other in (("point-major", pm), ("tile-major", tm)):
            for what, a, b in zip(("tmp", "scal", "out"), other,
                                  (tmp, scal, out)):
                if what == "out" and not hit:
                    continue
                if not layout_diff and not bool(jnp.array_equal(a, b)):
                    layout_diff = (
                        f"{name} layout differs from slim at chunk {t0}: "
                        f"{what} at {int(jnp.sum(a != b))} values, max "
                        f"{float(jnp.max(jnp.abs(a - b))):.3g}")
        got = ps.unpack_state(tmp, scal, model.grid.nlayers, state)
        if not bool(jnp.array_equal(got.failed, state.failed)):
            fail(f"failed-point masks differ at chunk {t0}")
        compare(worst, got, out[0], state, ref_rows, hit)

    log(f"parity, kernel vs XLA, {n_points} points x {t_total} steps, "
        f"state after every {CHUNK}-step chunk and hourly outputs (worst "
        f"check): max |diff|, 99.9th pct, points outside rtol 2e-5 / atol "
        f"2e-4 K or 2e-3 mm, values not bitwise equal")
    errors = []
    for name, (mx, p999, nbad, ndiff) in worst.items():
        log(f"  {name:10s} {mx:10.3g} {p999:10.3g} {nbad:8d} {ndiff:8d}")
        if name in ("tmp", "tsurf", "out_tsurf") and mx > 0.05:
            errors.append(f"{name}: kernel and XLA differ by {mx:.3g} K "
                          f"(> 0.05 K)")
    nbad = max(w[2] for w in worst.values())
    log(f"points outside the repo tolerance: {nbad}")
    if nbad:
        errors.append(f"{nbad} points outside the repo tolerance")
    log("layouts: " + (layout_diff or "point-major, tile-major and slim "
                       "agree bitwise"))
    if layout_diff:
        errors.append(layout_diff)
    if errors:
        fail("; ".join(errors))


def phase_cli(datadir: str, stations: int, ny: int, nx: int,
              hours=(48, 26)):
    """tools/gen_production.py data through runner.run(engine='auto')."""
    import jax
    import numpy as np

    from roadsurf_tpu import runner
    from roadsurf_tpu.observability import RunMetrics
    from tools.gen_production import main as gen_main

    cfg = os.path.join(datadir, "config.json")
    t0 = time.perf_counter()
    gen_main(["--outdir", datadir, "--stations", str(stations),
              "--ny", str(ny), "--nx", str(nx), "--analysis", str(hours[0]),
              "--forecast", str(hours[1])])
    log(f"generated the workload in {time.perf_counter() - t0:.1f} s")
    # the generated data has no gaps: hold the run to a missing budget of
    # 0 %, so the runner itself stops if any point fails
    with open(cfg) as f:
        config = json.load(f)
    config["missing_limit"] = 0
    with open(cfg, "w") as f:
        json.dump(config, f, indent=1)
    assert runner._resolve_engine("auto", None, None) == "pallas"
    metrics = RunMetrics()
    t0 = time.perf_counter()
    try:
        state, fields = runner.run(cfg, engine="auto", verbose=True,
                                   metrics=metrics)
    except SystemExit as e:
        fail(f"the runner stopped: {e}")
    wall = time.perf_counter() - t0
    if "point_steps_per_s" not in metrics.counters:
        fail("the streamed engine did not run")
    n = int(metrics.counters["points"])
    steps = int(metrics.counters["steps"])
    want = (ny * nx, 1 + sum(hours) * 120)
    if (n, steps) != want:
        fail(f"ran {n} points x {steps} steps, want {want[0]} x {want[1]}")
    failed = np.asarray(state.failed)
    ok = ~failed
    for name, v in fields.items():
        if name == "steps":
            continue
        if not np.isfinite(np.asarray(v)[:, ok]).all():
            fail(f"non-finite {name} output at a point that did not fail")
    if failed.any():
        fail(f"{int(failed.sum())} points failed (missing budget 0 %)")
    log(f"CLI: {n} points x {steps} steps in {wall:.1f} s wall, "
        f"{metrics.counters['point_steps_per_s'] / 1e6:.1f} M point-steps/s "
        f"streamed, no point failed (missing budget 0 %)")
    log("CLI phases (s): " + json.dumps(
        {k: round(v, 2) for k, v in metrics.phases.items()}))
    del state, fields
    jax.clear_caches()


def phase_coupled(n_points: int, n_steps: int, stations: int = 2048):
    """The operational example2 stack: grid + station obs, coupled."""
    import numpy as np

    from roadsurf_tpu import production
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.forcing import Calendar
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.observability import RunMetrics
    from roadsurf_tpu.parallel.sharding import make_mesh
    from roadsurf_tpu.state import default_point_params

    dt, S = 30.0, stations
    end_i = min(1 + int(24 * 3600 / dt), n_steps // 2)   # 24 h analysis
    start_i = max(1, end_i - 360 + 1)                     # 180-min window
    settings = ModelSettings(sim_len=n_steps, dt=dt, use_coupling=True,
                             output_step_minutes=60)
    model = Model(settings)
    rng = np.random.default_rng(7)
    raw_st, _ = synthetic_raw(S, n_steps, dt=dt, seed=7,
                              scenario="winter_mix", dtype=np.float32)
    mesh = make_mesh()
    st_idx = rng.integers(0, S, size=n_points)
    t0e = 1575158400
    sim_ep = t0e + (dt * np.arange(n_steps)).astype(np.int64)
    cal = Calendar.from_epochs(sim_ep)
    gtimes = t0e + 3600 * np.arange(1 + int(n_steps * dt // 3600) + 1,
                                    dtype=np.int64)
    ny, nx = 300, 400
    gf = {n: rng.normal(0.0 if n in ("prec", "sw") else -3.0, 2.0,
                        (len(gtimes), ny, nx))
          for n in ("tair", "tdew", "rhz", "vz", "prec", "sw", "lw")}
    gf["rhz"] = np.abs(gf["rhz"]) + 60.0
    gf["vz"] = np.abs(gf["vz"]) + 1.0
    gf["prec"] = np.abs(gf["prec"])
    gf["sw"] = np.abs(gf["sw"])
    gf["lw"] = 280.0 + gf["lw"]
    gf["prec_phase"] = rng.integers(0, 4, (len(gtimes), ny, nx)).astype(
        float)
    # stations contribute only their road-surface obs (example2's coupled
    # operational stack, roadrunner.cpp:763-792)
    tair_end = np.asarray(raw_st.tair)[st_idx, end_i - 1]
    miss = np.full_like(np.asarray(raw_st.tair), -9999.9)
    obs_only = raw_st._replace(**{
        n: (np.full_like(np.asarray(raw_st.prec_phase), -9999)
            if n == "prec_phase" else miss)
        for n in raw_st._fields if n != "tsurf_obs"})
    st_part = production.StationExpander(obs_only, st_idx, mesh,
                                         chunk_t=CHUNK, raw_tm=True)
    if st_part.point_perm is None:
        fail("the fused tile-major station part did not engage")
    g_part = production.GridExpander(
        gtimes, np.linspace(59.6, 70.1, ny), np.linspace(20.5, 31.6, nx),
        gf, rng.uniform(59.6, 70.1, n_points),
        rng.uniform(20.5, 31.6, n_points), sim_ep, mesh, chunk_t=CHUNK,
        point_perm=st_part.point_perm,
        tile_p=st_part._fused_plan["tile_p"])
    expander = production.CompositeExpander([g_part, st_part])
    pts = default_point_params(n_points)._replace(
        lat=rng.uniform(59.6, 70.1, n_points),
        lon=rng.uniform(20.5, 31.6, n_points),
        coupling_start=np.full(n_points, start_i, np.int32),
        coupling_end=np.full(n_points, end_i, np.int32),
        coupling_tsurf=(tair_end - 1.5).astype(np.float64))
    first = {n: np.asarray(getattr(raw_st, n))[st_idx, 0]
             for n in ("tair", "vz", "rhz", "tsurf_obs")}
    state0 = model.init(
        raw_st._replace(**{n: first[n][:, None] for n in first}), cal,
        dtype=np.float32)
    metrics = RunMetrics()
    res = production.run_production_coupled(
        model, expander, pts, cal, state0, mesh=mesh, chunk_t=CHUNK,
        metrics=metrics)
    tsurf = res.fields["tsurf"]
    failed = np.asarray(res.state.failed)
    if tsurf.shape != (-(-n_steps // 120), n_points):
        fail(f"coupled output shape {tsurf.shape}")
    if not np.isfinite(tsurf[:, ~failed]).all():
        fail("non-finite coupled output")
    log(f"coupled: {n_points} points x {n_steps} steps, "
        f"{metrics.counters.get('coupling_reruns')} window re-runs, "
        f"{res.point_steps_per_s / 1e6:.1f} M point-steps/s, failed "
        f"{failed.mean():.4%}; phases (s) " + json.dumps(
            {k: round(v, 2) for k, v in metrics.phases.items()}))


def phase_skyview(n_points: int, n_chunks: int, stations: int = 2048):
    """Per-point sky view + horizons through the fused-generic chunk."""
    import jax
    import numpy as np

    from roadsurf_tpu import production
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.ops import pallas_step as ps
    from roadsurf_tpu.parallel.sharding import make_mesh
    from roadsurf_tpu.state import default_point_params

    S, T = stations, n_chunks * CHUNK + 1
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False)
    model = Model(settings)
    rng = np.random.default_rng(5)
    raw_st, cal = synthetic_raw(S, T, dt=30.0, seed=5,
                                scenario="winter_mix", dtype=np.float32)
    mesh = make_mesh()
    st_idx = rng.integers(0, S, size=n_points)
    exp = production.StationExpander(raw_st, st_idx, mesh, chunk_t=CHUNK,
                                     raw_tm=True)
    hor = rng.uniform(0.0, 12.0, (n_points, 360)).astype(np.float32)
    pts = default_point_params(n_points)._replace(
        lat=rng.uniform(59.6, 70.1, n_points),
        lon=rng.uniform(20.5, 31.6, n_points),
        sky_view=rng.uniform(0.6, 0.95, n_points), horizons=hor)
    first = {n: np.asarray(getattr(raw_st, n))[st_idx, :1]
             for n in ("tair", "vz", "rhz", "tsurf_obs")}
    state0 = model.init(raw_st._replace(**first), cal, dtype=np.float32)
    eng = production._Engine(model, exp, pts, cal, state0, mesh=mesh,
                             chunk_t=CHUNK)
    if not (eng.fused_generic and eng.enable_sky and not eng.flat_horizons):
        fail("sky view with horizons did not take the fused-generic path")
    tmp, scal = eng.tmp0, eng.scal0
    fn = eng.chunk_fn(CHUNK, False)
    t0 = time.perf_counter()
    for k in range(n_chunks):
        tmp, scal, rows = fn(tmp, scal, np.int32(k * CHUNK), eng.data)
    jax.block_until_ready(scal)
    wall = time.perf_counter() - t0
    s = np.asarray(scal)
    if not np.isfinite(s).all() or s[ps.R_FAILED].any():
        fail("sky-view chunk produced non-finite or failed points")
    log(f"sky view: {n_chunks} chunks x {CHUNK} steps at {n_points} points "
        f"in {wall:.2f} s (compile included)")


def phase_highest(n_points: int, stations: int = 2048):
    """One-hot Precision.HIGHEST expansion == row gather, bit for bit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from roadsurf_tpu import production
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.ops import pallas_step as ps
    from roadsurf_tpu.parallel.sharding import make_mesh
    from roadsurf_tpu.state import default_point_params

    S, T = stations, 2 * CHUNK + 1
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False)
    model = Model(settings)
    raw_st, cal = synthetic_raw(S, T, dt=30.0, seed=9,
                                scenario="winter_mix", dtype=np.float32)
    st_idx = np.random.default_rng(9).integers(0, S, size=n_points)
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": settings, "params": model.params,
           "hour": cal.hour, "t_total": T}
    exp = production.StationExpander(raw_st, st_idx, make_mesh(),
                                     chunk_t=CHUNK, prep_ctx=ctx)
    if exp.point_perm is None:
        fail("the fused one-hot expansion did not engage")
    data = exp.device_data

    @jax.jit
    def both(data, t0):
        fused = exp.fused_window(data, t0, CHUNK)
        ones = jnp.ones((CHUNK, exp.num_points), jnp.float32)
        gather = exp.packed_window(data, t0, CHUNK, ones, ones,
                                   jnp.zeros((exp.num_points,)))
        fused = jnp.transpose(fused, (1, 2, 0, 3, 4)).reshape(
            CHUNK, ps.NCH_SLIM, -1)
        return fused, gather[:, list(ps.SLIM_CHANNELS)]

    for t0 in (0, CHUNK):
        a, b = both(data, np.int32(t0))
        if not bool(jnp.array_equal(a, b)):
            n = int(jnp.sum(a != b))
            fail(f"one-hot expansion differs from the row gather at {n} "
                 f"values (t0={t0})")
    log(f"one-hot HIGHEST expansion == row gather, bitwise, at "
        f"{n_points} points")


def four_cards(n_per_card: int, n_steps: int, stations: int = 2048):
    """Station-fed engine on a 4-card mesh vs the same points on 1 card."""
    import jax
    import numpy as np

    from roadsurf_tpu import production
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.parallel.sharding import make_mesh
    from roadsurf_tpu.state import default_point_params

    devices = jax.devices()
    if len(devices) < 4:
        fail(f"--four-cards needs 4 GPUs, found {len(devices)}")
    n_points = 4 * n_per_card
    S = stations
    settings = ModelSettings(sim_len=n_steps, dt=30.0, use_relaxation=False,
                             output_step_minutes=60)
    model = Model(settings)
    raw_st, cal = synthetic_raw(S, n_steps, dt=30.0, seed=13,
                                scenario="winter_mix", dtype=np.float32)
    st_idx = np.random.default_rng(13).integers(0, S, size=n_points)
    pts = default_point_params(n_points)
    first = {n: np.asarray(getattr(raw_st, n))[st_idx, :1]
             for n in ("tair", "vz", "rhz", "tsurf_obs")}
    state0 = model.init(raw_st._replace(**first), cal, dtype=np.float32)
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": settings, "params": model.params,
           "hour": cal.hour, "t_total": n_steps}
    res = {}
    for label, devs in (("4 cards", devices[:4]), ("1 card", devices[:1])):
        mesh = make_mesh(devs)
        exp = production.StationExpander(raw_st, st_idx, mesh,
                                         chunk_t=CHUNK, prep_ctx=ctx)
        r = production.run_production(model, exp, pts, cal, state0,
                                      mesh=mesh, chunk_t=CHUNK)
        res[label] = r
        log(f"{label}: {n_points} points x {n_steps} steps, "
            f"{r.point_steps_per_s / 1e6:.1f} M point-steps/s "
            f"(fused={exp.point_perm is not None})")
        del exp
    a, b = res["4 cards"], res["1 card"]
    for name in a.fields:
        if not np.array_equal(a.fields[name], b.fields[name]):
            fail(f"4-card {name} outputs differ from the 1-card run")
    for x, y in zip(jax.tree.leaves(a.state), jax.tree.leaves(b.state)):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            fail("4-card final state differs from the 1-card run")
    log("4-card run == 1-card run, bitwise (outputs and final state)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded engine check")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "roadsurf_tpu")):
        abort(f"no roadsurf_tpu package beside {__file__}")
    sys.path.insert(0, REPO)
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    card = card_line()
    phase = Phases()

    if not args.four_cards:
        phase.run("b: pytest -m gpu", run_gpu_tests)

    import jax

    from roadsurf_tpu import use_compile_cache
    cache = use_compile_cache()
    cache_events = count_cache_events()
    devs = jax.devices()
    d = devs[0]
    log(f"--- phase a: platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devs)} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache}")
    if any(x.platform != "gpu" for x in devs):
        abort(f"platform is {d.platform!r}, not gpu")

    if args.four_cards:
        phase.run("four cards: 4 x 1M points, sharded vs 1 card",
                  four_cards, P_REAL, 2881)
    else:
        phase.run("c: kernel vs XLA parity, 1M points x 2880 steps",
                  phase_parity, P_REAL, 2880)
        phase.run("d: CLI, 1M points x 8881 steps", phase_cli,
                  os.path.join(REPO, "chip_smoke_data"), 2048, 1024, 1024)
        phase.run("e: coupled grid + station obs, 1M points",
                  phase_coupled, P_REAL, 8881)
        phase.run("f: sky view with horizons, 1M points",
                  phase_skyview, P_REAL, 3)
        phase.run("g: one-hot HIGHEST expansion == row gather",
                  phase_highest, P_REAL)

    log("phase times (s): " + json.dumps(
        {k: round(v, 1) for k, v in phase.times.items()}))
    log(f"compile cache {cache}: {cache_events['hits']} hits, "
        f"{cache_events['misses']} misses")
    if phase.failed:
        abort("; ".join(phase.failed))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
