"""Fused one-hot station->point expansion (the tile-major kernel forcing
path).

Instead of a station row-gather + transpose before the kernel, the fused
path sorts points by station within each device block, making every
kernel tile's stations a small contiguous window, and expands station->point
with one batched one-hot matmul (bit-exact selection at
Precision.HIGHEST), writing the kernel's tile-major layout directly --
no transpose, no point-major intermediate.

Selection by matmul is bit-exact, so fused runs must equal the row-gather
fast path EXACTLY (assert_array_equal, not allclose).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from roadsurf_tpu import production
from roadsurf_tpu.forcing import relax_anchors
from roadsurf_tpu.model import Model
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params

from test_production import (_station_setup, _station_prep_ctx,
                             _coupled_setup)


def _expanders(settings, model, raw_st, cal, pts, st_idx, mesh,
               chunk_t=32, obs_st=None):
    P = len(st_idx)
    p_pad = production.padded_points(P, mesh)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)
    ctx = _station_prep_ctx(settings, model, raw_st, cal, pts, st_idx)
    if obs_st is not None:
        ctx["st_pts"] = ctx["st_pts"]._replace(
            coupling_tsurf=np.concatenate([obs_st, [-9999.9]]))
    mk = lambda fused: production.StationExpander(
        raw_st, st_idx_pad, mesh, chunk_t=chunk_t, prep_ctx=ctx, fused=fused)
    return mk(True), mk(False)


def test_fused_engages_and_matches_gather_bitwise():
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup(
        skyview=False)
    mesh = make_mesh()
    exp_f, exp_g = _expanders(settings, model, raw_st, cal, pts, st_idx,
                              mesh)
    assert exp_f.point_perm is not None and "fused" in exp_f.prep_data
    assert exp_g.point_perm is None

    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    anchors = relax_anchors(raw_pt, pts)
    runs = {}
    for label, exp in (("fused", exp_f), ("gather", exp_g)):
        eng = production._Engine(model, exp, pts, cal, state0,
                                 anchors=anchors, mesh=mesh, chunk_t=32,
                                 out_stride=6)
        assert eng.fast
        assert eng.fused == (label == "fused")
        runs[label] = production.run_production(
            model, exp, pts, cal, state0, anchors=anchors, mesh=mesh,
            chunk_t=32, out_stride=6)
    for name in runs["fused"].fields:
        np.testing.assert_array_equal(runs["fused"].fields[name],
                                      runs["gather"].fields[name],
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(runs["fused"].state.tmp),
                                  np.asarray(runs["gather"].state.tmp))
    assert np.array_equal(np.asarray(runs["fused"].state.failed),
                          np.asarray(runs["gather"].state.failed))


def test_fused_coupled_matches_gather_bitwise():
    """Coupled driver with fused phase A + generic phase B + row-gather
    phase C must equal the all-row-gather coupled run bit for bit."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _coupled_setup()
    P = len(st_idx)
    rng = np.random.default_rng(5)
    S = np.asarray(raw_st.tair).shape[0]
    obs_st = np.asarray(raw_st.tair)[:, 39] - rng.uniform(0.5, 2.5, S)
    obs_st[2] = -9999.9
    obs_pt = np.where(st_idx >= 0, obs_st[np.where(st_idx >= 0, st_idx, 0)],
                      -9999.9)
    pts = pts._replace(coupling_tsurf=obs_pt)
    mesh = make_mesh()
    exp_f, exp_g = _expanders(settings, model, raw_st, cal, pts, st_idx,
                              mesh, obs_st=obs_st)
    assert exp_f.point_perm is not None

    state0 = model.init(raw_pt, cal, dtype=jnp.float32, pts=pts)
    runs = {}
    for label, exp in (("fused", exp_f), ("gather", exp_g)):
        runs[label] = production.run_production_coupled(
            model, exp, pts, cal, state0, mesh=mesh, chunk_t=32,
            out_stride=6)
    for name in runs["fused"].fields:
        np.testing.assert_array_equal(runs["fused"].fields[name],
                                      runs["gather"].fields[name],
                                      err_msg=name)
    assert np.array_equal(np.asarray(runs["fused"].state.failed),
                          np.asarray(runs["gather"].state.failed))


def test_coupled_fast_provider_matches_generic_bitwise():
    """Phase-B's station-prepared row-gather window provider (engaged
    whenever eng.fast; cuts the per-pass re-prep for windows too big to
    cache) must be bitwise the generic per-point prep provider."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _coupled_setup()
    P = len(st_idx)
    rng = np.random.default_rng(5)
    S = np.asarray(raw_st.tair).shape[0]
    obs_st = np.asarray(raw_st.tair)[:, 39] - rng.uniform(0.5, 2.5, S)
    obs_st[2] = -9999.9
    obs_pt = np.where(st_idx >= 0, obs_st[np.where(st_idx >= 0, st_idx, 0)],
                      -9999.9)
    pts = pts._replace(coupling_tsurf=obs_pt)
    mesh = make_mesh()
    _, exp_fast = _expanders(settings, model, raw_st, cal, pts, st_idx,
                             mesh, obs_st=obs_st)     # row-gather fast
    p_pad = production.padded_points(P, mesh)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)
    exp_plain = production.StationExpander(raw_st, st_idx_pad, mesh,
                                           chunk_t=32)  # generic prep
    state0 = model.init(raw_pt, cal, dtype=jnp.float32, pts=pts)
    runs = {}
    for label, exp in (("fast", exp_fast), ("generic", exp_plain)):
        runs[label] = production.run_production_coupled(
            model, exp, pts, cal, state0, mesh=mesh, chunk_t=32,
            out_stride=6)
    for name in runs["fast"].fields:
        np.testing.assert_array_equal(runs["fast"].fields[name],
                                      runs["generic"].fields[name],
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(runs["fast"].state.tmp),
                                  np.asarray(runs["generic"].state.tmp))


def test_fused_plan_autotunes_tile_for_dense_maps():
    """A dense station map that blows the span cap at the device-block
    default tile auto-tunes to a HALVED tile (spans shrink with the tile)
    instead of bailing to the row-gather path -- and
    stays bitwise-equal to the gather expansion."""
    # a tile of tile_p sorted points drawn from S stations spans
    # ~S * tile_p / p_loc rows: with p_loc=512 and S=800, the default
    # 512-point tile spans ~800 (smax 896 > 512 cap) while the halved
    # 256-point tile spans ~400 (smax 512, fits)
    S, P = 800, 4096
    settings, model, raw_st, _, cal, pts, _ = _station_setup(
        S=S, P=P, T=49, skyview=False, use_relaxation=False)
    rng = np.random.default_rng(5)
    st_idx = rng.integers(0, S, size=P)
    from roadsurf_tpu.forcing import RawForcing
    raw_pt = RawForcing(*(np.asarray(getattr(raw_st, n))[st_idx]
                          for n in RawForcing._fields))
    mesh = make_mesh()
    exp_f, exp_g = _expanders(settings, model, raw_st, cal, pts, st_idx,
                              mesh)
    assert exp_f.point_perm is not None, "auto-tune must find a tile"
    assert exp_f._fused_plan["tile_p"] == 256, exp_f._fused_plan["tile_p"]
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    res = production.run_production(
        model, exp_f, pts, cal, state0, mesh=mesh, chunk_t=32,
        out_stride=12)
    ref = production.run_production(
        model, exp_g, pts, cal, state0, mesh=mesh, chunk_t=32,
        out_stride=12)
    for name in res.fields:
        np.testing.assert_array_equal(res.fields[name], ref.fields[name],
                                      err_msg=name)


def test_fused_infeasible_falls_back_to_gather():
    """Tiles spanning more than FUSED_SMAX_CAP station rows (dense many-
    station maps) must fall back to the row-gather fast path, not break.
    S=900 over 128-point tiles spans ~900 rows > the 512 cap at every
    auto-tune candidate (128 is already the minimum tile)."""
    S = 900
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup(
        S=S, P=1000, skyview=False, use_relaxation=False)
    # every device block's 128 sorted points span ~S stations > the cap
    rng = np.random.default_rng(3)
    st_idx = rng.permutation(np.repeat(np.arange(S), -(-1000 // S))[:1000])

    def expand(x, fill):
        return np.asarray(x)[st_idx]

    from roadsurf_tpu.forcing import RawForcing
    raw_pt = RawForcing(
        *(expand(getattr(raw_st, n), None) for n in RawForcing._fields))
    mesh = make_mesh()
    exp_f, exp_g = _expanders(settings, model, raw_st, cal, pts, st_idx,
                              mesh)
    assert exp_f.point_perm is None          # plan rejected
    assert "fused" not in exp_f.prep_data
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    res = production.run_production(
        model, exp_f, pts, cal, state0, mesh=mesh, chunk_t=32,
        out_stride=12)
    ref = production.run_production(
        model, exp_g, pts, cal, state0, mesh=mesh, chunk_t=32,
        out_stride=12)
    for name in res.fields:
        np.testing.assert_array_equal(res.fields[name], ref.fields[name],
                                      err_msg=name)


def test_fused_ragged_and_stride_edges():
    """Fused path over awkward chunk shapes (prime T, stride > chunk) must
    still match the gather path bitwise -- the tile-major DMA uses the same
    nsteps masking and global output stride."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup(
        T=97, skyview=False, use_relaxation=False)
    mesh = make_mesh()
    exp_f, exp_g = _expanders(settings, model, raw_st, cal, pts, st_idx,
                              mesh, chunk_t=16)
    assert exp_f.point_perm is not None
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    for out_stride in (7, 19):
        a = production.run_production(
            model, exp_f, pts, cal, state0, mesh=mesh, chunk_t=16,
            out_stride=out_stride)
        b = production.run_production(
            model, exp_g, pts, cal, state0, mesh=mesh, chunk_t=16,
            out_stride=out_stride)
        for name in a.fields:
            np.testing.assert_array_equal(a.fields[name], b.fields[name],
                                          err_msg=f"{name}@{out_stride}")
