"""Sharded execution tests on an 8-virtual-device CPU mesh: results must be
identical to single-device, collectives must work, and padding must be safe."""
import jax
import jax.numpy as jnp
import numpy as np

from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model, scan_steps
from roadsurf_tpu.parallel.sharding import (check_missing_budget,
                                            failure_stats, make_mesh,
                                            pad_points, shard_prepared,
                                            shard_state)
from roadsurf_tpu.state import default_point_params


def _setup(npoints=16, sim_len=121):
    settings = ModelSettings(sim_len=sim_len, dt=30.0)
    model = Model(settings)
    raw, cal = synthetic_raw(npoints, sim_len, seed=2)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    state = model.init(raw, cal, dtype=prep.tair.dtype)
    return model, prep, state, pts


def test_sharded_matches_single_device():
    model, prep, state, pts = _setup()
    obs = jnp.asarray(pts.coupling_tsurf)
    ones = jnp.ones(prep.tair.shape, prep.tair.dtype)

    final_ref, out_ref = scan_steps(state, prep, ones, ones, obs, model.cfg,
                                    model.grid, model.params)

    mesh = make_mesh()
    assert len(mesh.devices.ravel()) == 8
    state_s = shard_state(state, mesh)
    prep_s = shard_prepared(prep, mesh)
    fn = jax.jit(lambda st, pr, sw, lw: scan_steps(
        st, pr, sw, lw, obs, model.cfg, model.grid, model.params))
    final_s, out_s = fn(state_s, prep_s, ones, ones)

    np.testing.assert_allclose(np.asarray(out_s.tsurf),
                               np.asarray(out_ref.tsurf), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(final_s.tmp),
                               np.asarray(final_ref.tmp), rtol=1e-12)
    # outputs keep the points sharding
    shard_names = {type(final_s.tsurf_ave.sharding).__name__}
    assert final_s.tsurf_ave.sharding.is_fully_replicated is False


def test_failure_stats_psum():
    mesh = make_mesh()
    failed = jnp.zeros(16, bool).at[3].set(True).at[9].set(True)
    failed = jax.device_put(
        failed, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("points")))
    cnt, ratio = failure_stats(failed, mesh)
    assert int(cnt) == 2
    assert np.isclose(float(ratio), 2 / 16)
    assert check_missing_budget(failed, 0.10, mesh) is True
    assert check_missing_budget(failed, 0.50, mesh) is False


def test_pallas_sharded_matches_single_device():
    """The fused Pallas kernel under shard_map (interpret mode on the CPU
    mesh) must produce bitwise-identical results to the unsharded kernel:
    each device runs the identical per-point program on its own block."""
    from roadsurf_tpu.ops import pallas_step as ps
    from roadsurf_tpu.parallel.sharding import pallas_scan_sharded

    npoints, sim_len = 1024, 32
    settings = ModelSettings(sim_len=sim_len, dt=30.0)
    model = Model(settings)
    raw, cal = synthetic_raw(npoints, sim_len, seed=7, dtype=np.float32)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    prep = prep._replace(**{k: jnp.asarray(getattr(prep, k), jnp.float32)
                            for k in ("tair", "vz", "rhz", "rain", "snow",
                                      "sw", "lw", "tsurf_obs", "trf_fric")})
    state = model.init(raw, cal, dtype=jnp.float32)
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)

    tmp0, scal0 = ps.pack_state(state)
    forcing = ps.pack_forcing(prep, ones, ones, obs)

    tmp_ref, scal_ref, out_ref = ps.pallas_scan(
        tmp0, scal0, forcing, model.cfg, model.params, model.grid,
        out_stride=4, interpret=True)

    mesh = make_mesh()
    tmp_s, scal_s, out_s = pallas_scan_sharded(
        tmp0, scal0, forcing, model.cfg, model.params, model.grid, mesh,
        out_stride=4, interpret=True)
    assert not out_s.sharding.is_fully_replicated
    np.testing.assert_array_equal(np.asarray(tmp_s), np.asarray(tmp_ref))
    np.testing.assert_array_equal(np.asarray(scal_s), np.asarray(scal_ref))
    np.testing.assert_array_equal(np.asarray(out_s), np.asarray(out_ref))


def test_pad_points():
    model, prep, state, pts = _setup(npoints=13, sim_len=61)
    padded, orig = pad_points(state, 8)
    assert orig == 13
    assert padded.tsurf_ave.shape[0] == 16
    # edge padding repeats the last point
    np.testing.assert_array_equal(np.asarray(padded.tmp)[13:],
                                  np.broadcast_to(np.asarray(padded.tmp)[12],
                                                  (3,) + padded.tmp.shape[1:]))
