"""The fused kernel's GPU route, checked without a card: every variant lowers
for CUDA (Pallas -> Triton IR), the block grid over tiles and padding, the
choice between compiled and interpreted kernels, and the compile-cache and
memory-budget helpers the engine sizes itself with."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roadsurf_tpu import production, runner
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model, scan_steps
from roadsurf_tpu.ops import pallas_step as ps
from roadsurf_tpu.state import default_point_params

P, T = 1024, 16


def _sds(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


_VARIANTS = {
    "point_major": (_sds(T, ps.NCH, P), {}),
    "tile_major": (_sds(P // 256, T, ps.NCH, 2, ps.LANE), {}),
    "slim": (_sds(P // 256, T, ps.NCH_SLIM, 2, ps.LANE),
             {"slim_trf": _sds(T), "aux_rows": _sds(4, P)}),
    "slim_cofs": (_sds(P // 256, T, ps.NCH_SLIM, 2, ps.LANE),
                  {"slim_trf": _sds(T), "aux_rows": _sds(4, P),
                   "aux_cofs": True, "t_total": 100, "cof_red": 3600.0}),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_kernel_lowers_for_cuda(variant):
    model = Model(ModelSettings(sim_len=T, dt=30.0))
    forc, kw = _VARIANTS[variant]
    arrays = {k: v for k, v in kw.items()
              if isinstance(v, jax.ShapeDtypeStruct)}
    static = {k: v for k, v in kw.items() if k not in arrays}

    def f(tmp, scal, forc, off, arrays):
        return ps.pallas_scan(tmp, scal, forc, model.cfg, model.params,
                              model.grid, out_stride=4, out_offset=off,
                              n_out=4, **arrays, **static)

    l2 = model.grid.nlayers + 2
    lowered = jax.jit(f).trace(
        _sds(l2, P), _sds(ps.NROWS, P), forc, _sds(dtype=jnp.int32),
        arrays).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text, variant
    assert "roadsurf_scan" in text


def _kernel_inputs(npoints=512, sim_len=24, seed=4, with_prep=False):
    model = Model(ModelSettings(sim_len=sim_len, dt=30.0))
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed,
                             scenario="cold_snow", dtype=np.float32)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    prep = prep._replace(**{k: jnp.asarray(getattr(prep, k), jnp.float32)
                            for k in ("tair", "vz", "rhz", "rain", "snow",
                                      "sw", "lw", "tsurf_obs", "trf_fric")})
    state = model.init(raw, cal, dtype=jnp.float32)
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)
    forc = ps.pack_forcing(prep, ones, ones, obs)
    if with_prep:
        return model, state, forc, (prep, ones, obs)
    return model, state, forc


@pytest.mark.parametrize("npoints,subl", [
    (128, None), (384, None), (640, None),     # point-major: one tile
    (128, 1), (384, 1), (640, 5), (1024, 2),   # tile-major: 1, 3, 1, 4 tiles
])
def test_kernel_runs_every_point(npoints, subl):
    """Every point of every tile is run by one program: at point counts
    that are odd multiples of LANE the kernel matches the XLA scan at every
    point, in either layout."""
    model, state, forc, (prep, ones, obs) = _kernel_inputs(
        npoints=npoints, sim_len=8, with_prep=True)
    tmp0, scal0 = ps.pack_state(state)
    if subl is not None:
        forc = jnp.transpose(forc.reshape(forc.shape[0], ps.NCH, -1, subl,
                                          ps.LANE), (2, 0, 1, 3, 4))
    tmp_f, scal_f, _ = ps.pallas_scan(tmp0, scal0, forc, model.cfg,
                                      model.params, model.grid,
                                      interpret=True)
    ref, _ = scan_steps(state, prep, ones, ones, obs, model.cfg,
                        model.grid, model.params, collect=False)
    np.testing.assert_allclose(np.asarray(tmp_f).T, np.asarray(ref.tmp),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(scal_f[ps.R_WAT]),
                               np.asarray(ref.wat), rtol=2e-5, atol=2e-3)


def test_point_count_off_the_lane_quantum_is_refused():
    model, state, forc = _kernel_inputs(npoints=512, sim_len=4)
    tmp0, scal0 = ps.pack_state(state)
    with pytest.raises(AssertionError):
        ps.pallas_scan(tmp0[:, :500], scal0[:, :500], forc[:, :, :500],
                       model.cfg, model.params, model.grid, interpret=True)


@pytest.mark.parametrize("block", [64, 128])
def test_block_does_not_change_results(monkeypatch, block):
    """Masked-freeze boundary-layer iterations make each point's result
    independent of which points share its program: a bench sweep that
    rebinds BLOCK gives bitwise the scan of the default block."""
    model, state, forc = _kernel_inputs()
    tmp0, scal0 = ps.pack_state(state)
    run = lambda: ps.pallas_scan(tmp0, scal0, forc, model.cfg, model.params,
                                 model.grid, out_stride=3, interpret=True)
    runs = [run()]
    monkeypatch.setattr(ps, "BLOCK", block)
    runs.append(run())
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_layouts_agree_and_padded_profile_rows_pass_through():
    """Point-major and tile-major forcing give bitwise the same scan, and
    profile rows past L+2 (an over-padded tmp) come back unchanged."""
    model, state, forc = _kernel_inputs()
    l2 = model.grid.nlayers + 2
    tmp0, scal0 = ps.pack_state(state, lpad=l2 + 3)
    assert tmp0.shape[0] == l2 + 3
    tmp0 = tmp0.at[l2:].set(7.0)
    tm = jnp.transpose(forc.reshape(forc.shape[0], ps.NCH, -1, 2, ps.LANE),
                       (2, 0, 1, 3, 4))
    a = ps.pallas_scan(tmp0, scal0, forc, model.cfg, model.params,
                       model.grid, interpret=True)
    b = ps.pallas_scan(tmp0, scal0, tm, model.cfg, model.params,
                       model.grid, interpret=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(a[0][l2:]), 7.0)
    assert ps.pack_state(state)[0].shape[0] == l2     # no padding by default


class _FakeMesh:
    def __init__(self, platform):
        dev = type("Dev", (), {"platform": platform})()
        self.devices = np.asarray([dev], dtype=object)


def test_kernel_interpret_only_on_cpu():
    assert production.kernel_interpret(_FakeMesh("gpu")) is False
    assert production.kernel_interpret(_FakeMesh("cpu")) is True
    with pytest.raises(ValueError, match="no 'rocm' build"):
        production.kernel_interpret(_FakeMesh("rocm"))


def test_auto_engine_by_backend(monkeypatch):
    assert runner._resolve_engine("auto", None, None) == "scan"
    assert runner._resolve_engine("pallas", None, None) == "pallas"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert runner._resolve_engine("auto", None, None) == "pallas"
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError):
        runner._resolve_engine("auto", None, None)


def test_memory_budgets_follow_the_device():
    """Chunk sizing reads the device's memory: 64-step chunks at 1M points
    whenever two point-major forcing chunks fit, longer chunks at small
    point counts, and a cap when memory is short."""
    dev_bytes = production.device_bytes()
    assert dev_bytes > 0
    if production.CHUNK_MEM_SHARE * dev_bytes >= 2 * (1 << 20) * ps.NCH * 256:
        assert production.auto_chunk_t(1 << 20) == 64
    assert production.auto_chunk_t(1 << 14) == 1024

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 80e9}
    assert production.device_bytes(Dev()) == 80e9


def test_compile_cache_dir(monkeypatch):
    import roadsurf_tpu
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert roadsurf_tpu.use_compile_cache() == "/somewhere/else"
    assert seen == []                 # JAX reads the variable itself
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert roadsurf_tpu.use_compile_cache() == roadsurf_tpu.COMPILE_CACHE_DIR
    assert seen == [("jax_compilation_cache_dir",
                     roadsurf_tpu.COMPILE_CACHE_DIR)]
    assert roadsurf_tpu.COMPILE_CACHE_DIR.endswith(".jax_cache")
