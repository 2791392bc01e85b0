"""Chunk-grid edge sweep for the streamed production engine.

The ragged/phase-boundary logic (the t_pad "+1 chunk" overhang, the k_alloc
output-row allocation, the coupled driver's non-aligned phase offsets) is
exercised here over deliberately awkward shape combinations -- prime T,
out_stride larger than the chunk, coupling windows straddling chunk
boundaries -- against the XLA scan engines.
All runs are interpret-mode on the 8-virtual-device CPU mesh at small P.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from roadsurf_tpu import production
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import RawForcing, relax_anchors
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params


def _setup(T, P=192, S=4, seed=11, use_coupling=False, ws=None, we=None):
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False,
                             use_coupling=use_coupling)
    model = Model(settings)
    raw_st, cal = synthetic_raw(S, T, seed=seed, dtype=np.float32)
    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::61] = -1

    def expand(x, fill):
        v = np.asarray(x)[np.where(st_idx >= 0, st_idx, 0)]
        return np.where((st_idx >= 0)[:, None], v, fill)

    raw_pt = RawForcing(
        *(expand(getattr(raw_st, n), -9999 if n == "prec_phase"
                 else np.float32(-9999.9)) for n in RawForcing._fields))
    pts = default_point_params(P)._replace(
        lat=58.0 + rng.uniform(0, 6, P), lon=20.0 + rng.uniform(0, 10, P))
    if use_coupling:
        obs = np.asarray(raw_pt.tair)[:, we - 1] - rng.uniform(0.5, 2.0, P)
        obs[::7] = -9999.9
        pts = pts._replace(coupling_start=np.full(P, ws, np.int32),
                           coupling_end=np.full(P, we, np.int32),
                           coupling_tsurf=obs)
    return settings, model, raw_st, raw_pt, cal, pts, st_idx


def _expander(raw_st, st_idx, mesh, chunk_t):
    p_pad = production.padded_points(len(st_idx), mesh)
    st_idx_pad = np.pad(st_idx, (0, p_pad - len(st_idx)),
                        constant_values=-1)
    return production.StationExpander(raw_st, st_idx_pad, mesh,
                                      chunk_t=chunk_t)


@pytest.mark.parametrize("T,chunk_t,out_stride", [
    (53, 16, 19),     # prime T, stride > chunk_t (some chunks emit no rows)
    (31, 24, 7),      # T barely above one chunk, ragged 7-step tail
    (97, 32, 40),     # stride > chunk, hits at 0/40/80 span chunk triples
    (41, 40, 41),     # single output row; chunk nearly the whole run
])
def test_uncoupled_chunk_grid_sweep(T, chunk_t, out_stride):
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _setup(T)
    final_ref, out_ref = model.run(raw_pt, pts, cal)
    mesh = make_mesh()
    exp = _expander(raw_st, st_idx, mesh, chunk_t)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    res = production.run_production(
        model, exp, pts, cal, state0, mesh=mesh, chunk_t=chunk_t,
        out_stride=out_stride)
    want_steps = np.arange(0, T, out_stride)
    assert np.array_equal(res.out_steps, want_steps)
    np.testing.assert_allclose(
        res.fields["tsurf"], np.asarray(out_ref.tsurf)[want_steps],
        rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(res.state.tmp),
                               np.asarray(final_ref.tmp),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("T,chunk_t,ws,we,out_stride", [
    (67, 16, 7, 23, 11),    # window straddles the 16-step chunk boundary
    (67, 16, 17, 31, 5),    # window starts just past a boundary
    (71, 32, 3, 61, 13),    # window spans two chunk boundaries, prime T
    (47, 32, 30, 45, 46),   # phase C is a 2-step stub; single late out row
])
def test_coupled_window_offset_sweep(T, chunk_t, ws, we, out_stride):
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _setup(
        T, use_coupling=True, ws=ws, we=we)
    final_pc, out_pc = model.run_coupled(raw_pt, pts, cal,
                                         out_stride=out_stride)
    out_pc = np.asarray(out_pc)
    mesh = make_mesh()
    exp = _expander(raw_st, st_idx, mesh, chunk_t)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32, pts=pts)
    res = production.run_production_coupled(
        model, exp, pts, cal, state0, mesh=mesh, chunk_t=chunk_t,
        out_stride=out_stride)
    want_steps = np.arange(0, T, out_stride)
    assert np.array_equal(res.out_steps, want_steps)
    names = ["tsurf", "wat", "snow", "ice", "ice2", "dep"]
    for fi, name in enumerate(names):
        np.testing.assert_allclose(
            res.fields[name], out_pc[:, :, fi], rtol=2e-4, atol=2e-3,
            err_msg=name)
    assert np.array_equal(np.asarray(res.state.failed),
                          np.asarray(final_pc.failed))


def test_skyview_flat_horizons_matches_scan():
    """Sky-view factor active with all-zero (flat) horizons: the production
    engine's static flat-horizons path (skips the per-(point, step) horizon
    lookup, production._Engine.flat_horizons) must match the scan engine,
    which runs the generic lookup on the same zeros."""
    T = 49
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _setup(T)
    P = len(st_idx)
    sky = np.full(P, 1.0)
    sky[::2] = 0.65
    pts = pts._replace(sky_view=sky, horizons=np.zeros((P, 360)))
    final_ref, out_ref = model.run(raw_pt, pts, cal)
    mesh = make_mesh()
    exp = _expander(raw_st, st_idx, mesh, chunk_t=16)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    res = production.run_production(
        model, exp, pts, cal, state0, mesh=mesh, chunk_t=16,
        out_stride=8)
    want_steps = np.arange(0, T, 8)
    np.testing.assert_allclose(
        res.fields["tsurf"], np.asarray(out_ref.tsurf)[want_steps],
        rtol=2e-5, atol=2e-4)


def test_shard_npz_roundtrip(tmp_path):
    """write_shard_npz/merge_shards: range-manifest shard files reassemble
    exactly and reject non-tiling ranges (the multi-host output path,
    QueryDataTools.cpp:299-345 disjoint-row assembly re-designed)."""
    from roadsurf_tpu.io.writer import merge_shards, write_shard_npz
    rng = np.random.default_rng(0)
    steps = np.arange(0, 40, 8)
    fields = {n: rng.normal(size=(len(steps), 96)).astype(np.float32)
              for n in ("tsurf", "wat", "snow")}
    for i, (lo, hi) in enumerate([(0, 40), (40, 96)]):
        write_shard_npz(tmp_path / f"s{i}.npz", (lo, hi), steps,
                        {n: v[:, lo:hi] for n, v in fields.items()})
    msteps, mfields, _ = merge_shards(sorted(tmp_path.glob("s*.npz")))
    np.testing.assert_array_equal(msteps, steps)
    for n, v in fields.items():
        np.testing.assert_array_equal(mfields[n], v, err_msg=n)
    # a gap in the ranges must be rejected
    write_shard_npz(tmp_path / "bad.npz", (48, 96), steps,
                    {n: v[:, 48:] for n, v in fields.items()})
    with pytest.raises(ValueError, match="tile"):
        merge_shards([tmp_path / "s0.npz", tmp_path / "bad.npz"])


def test_shard_drain_single_process_matches_gather():
    """drain='shard' on a fully-addressable (single-process) run returns the
    full range and identical fields to drain='gather' -- incl. through the
    fused permutation's local inverse."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _setup(41)
    mesh = make_mesh()
    exp = _expander(raw_st, st_idx, mesh, chunk_t=16)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    a = production.run_production(model, exp, pts, cal, state0, mesh=mesh,
                                  chunk_t=16, out_stride=8)
    b = production.run_production(model, exp, pts, cal, state0, mesh=mesh,
                                  chunk_t=16, out_stride=8,
                                  drain="shard")
    assert b.point_range == (0, len(st_idx))
    for n in a.fields:
        np.testing.assert_array_equal(a.fields[n], b.fields[n], err_msg=n)
    np.testing.assert_array_equal(np.asarray(a.state.tmp),
                                  np.asarray(b.state.tmp))


def test_validation_counts_screen():
    """production.validation_counts: per-variable post-merge CheckValues
    screen (the grid-overlay replacement for the up-front station skip
    report, examples/example1/src/roadrunner.cpp:183-231)."""
    T, P, S = 37, 192, 4
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _setup(T, P=P, S=S)
    # poison station 1's rhz mid-series and station 2's vz ONLY at the final
    # step (exempt: CheckValues does not run on the lastValues step)
    rhz = np.asarray(raw_st.rhz).copy()
    rhz[1, 12] = -9999.9
    vz = np.asarray(raw_st.vz).copy()
    vz[2, T - 1] = 4000.0
    raw_st = raw_st._replace(rhz=rhz, vz=vz)
    mesh = make_mesh()
    exp = _expander(raw_st, st_idx, mesh, chunk_t=16)
    counts, n_bad = production.validation_counts(exp, mesh, T, chunk_t=16,
                                                 n_real=P)
    n_st1 = int((st_idx == 1).sum())
    # out-of-radius points carry all-MISSING forcing -> every var flagged
    n_oor = int((st_idx < 0).sum())
    assert counts["rhz"] == n_st1 + n_oor
    assert counts["vz"] == n_oor          # final-step-only value is exempt
    assert counts["tair"] == n_oor
    assert n_bad == n_st1 + n_oor


def test_raw_tm_chunk_halving_and_active_channels():
    """The raw-tm chunk memory rule (runner auto-halving) and the shared
    active-channel predicate."""
    import numpy as np

    from roadsurf_tpu import production
    from roadsurf_tpu.forcing import RawForcing

    rule = lambda c, p, n: production.raw_tm_chunk_t(c, p, n,
                                                    budget_bytes=8e9)
    # 11 active channels at 1M points: 64 -> 32 under an 8 GB budget
    assert rule(64, 1 << 20, 11) == 32
    # obs-only station part (1 active): 64 stays
    assert rule(64, 1 << 20, 1) == 64
    # floor respected
    assert rule(64, 1 << 24, 11) == 16
    # small point counts untouched
    assert rule(1024, 1 << 12, 11) == 1024
    # a non-power-of-two start halves to the first length that fits ...
    assert rule(216, 1 << 20, 11) == 27
    # ... and never undershoots the floor (27 -> 16, not 13)
    assert rule(216, 1 << 22, 11) == 16
    # the default budget is a share of the device's memory
    dev = production.CHUNK_MEM_SHARE * production.device_bytes()
    assert production.raw_tm_chunk_t(216, 1 << 20, 11) == \
        production.raw_tm_chunk_t(216, 1 << 20, 11, budget_bytes=dev)

    S, T = 4, 9
    miss = np.full((S, T), -9999.9, np.float32)
    raw = RawForcing(**{n: (np.full((S, T), -9999, np.int64)
                            if n == "prec_phase" else miss.copy())
                        for n in RawForcing._fields})
    assert production.active_channels(raw) == []
    tzo = miss.copy()
    tzo[2, 5] = -3.0
    raw2 = raw._replace(tsurf_obs=tzo)
    assert production.active_channels(raw2) == ["tsurf_obs"]
    # NaN is not the sentinel -> counts as active (sanitized at placement)
    tn = miss.copy()
    tn[0, 0] = np.nan
    raw3 = raw._replace(tair=tn)
    assert production.active_channels(raw3) == ["tair"]
