"""Multi-process distributed worker (spawned by test_distributed.py).

Each process owns 2 virtual CPU devices and ONLY its host_point_range slice
of the forcing (per-host IO, SURVEY.md section 2.4 P1); make_global assembles
the global sharded arrays; the same scan runs SPMD across processes.  The
worker then checks its addressable output shards against a locally-computed
single-process reference.

Usage: python _mp_worker.py <port> <num_processes> <process_id>
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    port, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc

    import numpy as np

    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.io.synthetic import synthetic_raw
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.parallel import distributed as dist
    from roadsurf_tpu.state import default_point_params

    P_total, T = 64, 49
    settings = ModelSettings(sim_len=T, dt=30.0)
    model = Model(settings)
    # deterministic global dataset; each host SLICES only its own range
    # (standing in for per-host file reads)
    raw_full, cal = synthetic_raw(P_total, T, seed=5, scenario="winter_mix")
    pts_full = default_point_params(P_total)
    lo, hi = dist.host_point_range(P_total)
    assert (hi - lo) == P_total // nproc
    raw_loc = jax.tree.map(lambda a: np.asarray(a)[lo:hi], raw_full)
    pts_loc = jax.tree.map(lambda a: np.asarray(a)[lo:hi], pts_full)

    mesh = dist.global_points_mesh()
    raw_g = dist.make_global(raw_loc, mesh, axis=0)
    pts_g = dist.make_global(pts_loc, mesh, axis=0)
    final, out = model.run(raw_g, pts_g, cal)

    # reference: this host's slice simulated single-process (host-local)
    _, out_ref = model.run(raw_loc, pts_loc, cal)
    ref = np.asarray(out_ref.tsurf)                  # [T, local_P]

    checked = 0
    for shard in out.tsurf.addressable_shards:
        sl = shard.index[1]
        assert lo <= sl.start and sl.stop <= hi, (sl, lo, hi)
        np.testing.assert_array_equal(
            np.asarray(shard.data), ref[:, sl.start - lo:sl.stop - lo])
        checked += sl.stop - sl.start
    assert checked == hi - lo, (checked, lo, hi)

    # the failure-budget psum reduces over the GLOBAL mesh
    from roadsurf_tpu.parallel.sharding import failure_stats
    cnt, ratio = failure_stats(final.failed, mesh)
    assert int(cnt) == 0 and float(ratio) == 0.0

    # --- the STREAMED production engine across processes ---------------
    # station channels replicate to every host; per-point data is global
    # device_put over the multi-process mesh; output drain allgathers
    import jax.numpy as jnp

    from roadsurf_tpu import production
    from roadsurf_tpu.forcing import RawForcing

    P2 = 128 * len(jax.devices())
    S = 6
    raw_st, cal2 = synthetic_raw(S, T, seed=9, scenario="winter_mix",
                                 dtype=np.float32)
    st_idx = (np.arange(P2) * 7) % S
    exp = production.StationExpander(raw_st, st_idx, mesh, chunk_t=16)
    raw_pt = RawForcing(*(np.asarray(getattr(raw_st, n))[st_idx]
                          for n in RawForcing._fields))
    pts2 = default_point_params(P2)
    state0 = jax.tree.map(np.asarray,
                          model.init(raw_pt, cal2, dtype=jnp.float32))
    res = production.run_production(model, exp, pts2, cal2, state0,
                                    mesh=mesh, chunk_t=16, out_stride=8)
    _, out_ref2 = model.run(raw_pt, pts2, cal2)
    want = np.asarray(out_ref2.tsurf)[::8]
    np.testing.assert_allclose(res.fields["tsurf"], want,
                               rtol=2e-4, atol=2e-3)
    assert not np.asarray(res.state.failed).any()

    # station-level prepared-channel fast path across processes: the
    # prepared channels replicate like the raw ones; must match the generic
    # multi-process run exactly
    exp_f = production.StationExpander(
        raw_st, st_idx, mesh, chunk_t=16,
        prep_ctx={"st_pts": default_point_params(S + 1), "anchors": None,
                  "settings": settings, "params": model.params,
                  "hour": cal2.hour, "t_total": T})
    res_f = production.run_production(model, exp_f, pts2, cal2, state0,
                                      mesh=mesh, chunk_t=16, out_stride=8)
    np.testing.assert_allclose(res_f.fields["tsurf"], res.fields["tsurf"],
                               rtol=2e-6, atol=2e-6)

    # --- per-shard multi-host output drain (NO cross-host allgather on
    # the output path): each process pulls only its addressable columns,
    # writes its shard with a range manifest, process 0 merges and checks
    # against the allgathered reference (QueryDataTools.cpp:299-345
    # disjoint-row assembly, re-designed for multi-host)
    import pathlib

    from jax.experimental import multihost_utils

    from roadsurf_tpu.io.writer import merge_shards, write_shard_npz

    res_s = production.run_production(model, exp_f, pts2, cal2, state0,
                                      mesh=mesh, chunk_t=16, out_stride=8,
                                      drain="shard")
    lo_s, hi_s = res_s.point_range
    assert hi_s - lo_s == P2 // nproc, (res_s.point_range, P2, nproc)
    np.testing.assert_array_equal(res_s.fields["tsurf"],
                                  res_f.fields["tsurf"][:, lo_s:hi_s])
    np.testing.assert_array_equal(np.asarray(res_s.state.tsurf_ave),
                                  np.asarray(res_f.state.tsurf_ave)
                                  [lo_s:hi_s])
    shard_dir = pathlib.Path(os.environ["MP_SHARD_DIR"])
    write_shard_npz(shard_dir / f"shard_{pid}.npz", res_s.point_range,
                    res_s.out_steps, res_s.fields)
    multihost_utils.sync_global_devices("shards_written")
    if pid == 0:
        steps, fields, _ = merge_shards(
            sorted(shard_dir.glob("shard_*.npz")))
        np.testing.assert_array_equal(steps, res_f.out_steps)
        for n in ("tsurf", "wat", "snow"):
            np.testing.assert_array_equal(fields[n], res_f.fields[n],
                                          err_msg=n)

    # --- COUPLED production across processes: the
    # segmented driver's phase-B window engine + decayed-cof phase C run
    # SPMD; per-shard drain columns must match the single-process scan
    # coupled engine ---------------------------------------------------
    from roadsurf_tpu.io.driver import derive_point_params

    settings_c = ModelSettings(sim_len=T, dt=30.0, use_coupling=True,
                               coupling_minutes=15.0)
    model_c = Model(settings_c)
    # plant a usable mid-run observation (the synthetic hourly obs cadence
    # leaves only step 0 valid at this short T)
    obs_arr = np.asarray(raw_st.tsurf_obs).copy()
    obs_arr[:, 40] = np.asarray(raw_st.tair)[:, 40] - 1.0
    raw_st = raw_st._replace(tsurf_obs=obs_arr)
    pts_st_c, blank_st = derive_point_params(raw_st, settings_c)
    raw_st_b = raw_st._replace(tsurf_obs=blank_st)
    exp_c = production.StationExpander(raw_st_b, st_idx, mesh, chunk_t=16)
    gp = lambda a: np.asarray(a)[st_idx]
    pts_c = pts2._replace(coupling_start=gp(pts_st_c.coupling_start),
                          coupling_end=gp(pts_st_c.coupling_end),
                          coupling_tsurf=gp(pts_st_c.coupling_tsurf))
    assert (np.asarray(pts_c.coupling_end) >= 1).any(), \
        "coupled section needs live coupling windows"
    raw_pt_b = RawForcing(*(np.asarray(getattr(raw_st_b, n))[st_idx]
                            for n in RawForcing._fields))
    state0_c = jax.tree.map(np.asarray,
                            model_c.init(raw_pt_b, cal2, dtype=jnp.float32,
                                         pts=pts_c))
    res_c = production.run_production_coupled(
        model_c, exp_c, pts_c, cal2, state0_c, mesh=mesh, chunk_t=16,
        out_stride=8, drain="shard")
    _, out_pc = model_c.run_coupled(raw_pt_b, pts_c, cal2, out_stride=8)
    out_pc = np.asarray(out_pc)
    lo_c, hi_c = res_c.point_range
    assert hi_c - lo_c == P2 // nproc, res_c.point_range
    np.testing.assert_allclose(res_c.fields["tsurf"],
                               out_pc[:, lo_c:hi_c, 0],
                               rtol=2e-4, atol=2e-3)

    # --- grid + composite (fused-generic tile-major) across processes --
    from roadsurf_tpu.io.gridsource import GridSource

    t0e = 1575158400
    sim2 = t0e + (30.0 * np.arange(T)).astype(np.int64)
    gtimes = t0e + 1800 * np.arange(2 + T // 60, dtype=np.int64)
    glats = np.linspace(60.0, 61.0, 3)
    glons = np.linspace(24.0, 25.5, 4)
    grng = np.random.default_rng(31)
    R = len(gtimes)
    gfields = {
        "tair": -4.0 + grng.normal(0, 1.0, (R, 3, 4)),
        "rhz": np.clip(80.0 + grng.normal(0, 10.0, (R, 3, 4)), 30, 100),
        "vz": np.abs(grng.normal(3.0, 1.0, (R, 3, 4))),
        "prec": np.abs(grng.normal(0.2, 0.2, (R, 3, 4))),
        "sw": np.abs(grng.normal(20.0, 10.0, (R, 3, 4))),
        "lw": 280.0 + grng.normal(0, 5.0, (R, 3, 4))}
    plat = np.clip(60.0 + grng.uniform(0, 1.0, P2), 60.0, 61.0)
    plon = np.clip(24.0 + grng.uniform(0, 1.5, P2), 24.0, 25.5)
    cal3 = type(cal2).from_epochs(sim2)
    sexp_g = production.StationExpander(raw_st_b, st_idx, mesh, chunk_t=16,
                                        raw_tm=True)
    gexp = production.GridExpander(
        gtimes, glats, glons, gfields, plat, plon, sim2, mesh, chunk_t=16,
        point_perm=sexp_g.point_perm,
        tile_p=(sexp_g._fused_plan["tile_p"]
                if sexp_g.point_perm is not None else None))
    comp = production.CompositeExpander([gexp, sexp_g])
    pts_g = pts2._replace(lat=plat, lon=plon)
    first = comp.first_host
    raw0 = RawForcing(*(np.broadcast_to(np.asarray(first[n])[:, None],
                                        (P2, T))
                        for n in RawForcing._fields))
    state0_g = jax.tree.map(np.asarray,
                            model.init(raw0, cal3, dtype=jnp.float32))
    eng_g = production._Engine(model, comp, pts_g, cal3, state0_g,
                               mesh=mesh, chunk_t=16)
    assert eng_g.fused_generic, "composite fused path must engage SPMD"
    res_g = production.run_production(model, comp, pts_g, cal3, state0_g,
                                      mesh=mesh, chunk_t=16, out_stride=8)
    # host reference: merged per-point series through the scan engine
    src = GridSource.__new__(GridSource)
    src.is_observation = False
    src.sim_times = sim2
    src.times, src.lats, src.lons = gtimes, glats, glons
    src.fields = {k: np.asarray(v, np.float64) for k, v in gfields.items()}
    vals = src.at_points(plat, plon)
    merged_pt = {}
    for n in RawForcing._fields:
        gv = vals.get(n)
        sv = np.asarray(getattr(raw_pt_b, n), np.float64)
        if gv is None:
            merged_pt[n] = sv
        else:
            thr = -1000.0 if n == "lw_net" else -100.0
            merged_pt[n] = np.where(sv > thr, sv, gv)
    raw_ref = RawForcing(**{
        n: (np.asarray(v, np.int64) if n == "prec_phase" else v)
        for n, v in merged_pt.items()})
    _, out_ref3 = model.run(raw_ref, pts_g, cal3)
    np.testing.assert_allclose(res_g.fields["tsurf"],
                               np.asarray(out_ref3.tsurf)[::8],
                               rtol=2e-4, atol=2e-3)

    print(f"MP_OK {pid} checked={checked} prod={res.fields['tsurf'].shape}")


if __name__ == "__main__":
    main()
