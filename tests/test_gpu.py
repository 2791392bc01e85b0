"""Card tests: the compiled (Triton) fused kernel and the streamed engine on
an NVIDIA GPU.  They skip without one; chip_smoke.py runs them on the card
with ``JAX_PLATFORMS=cuda pytest -m gpu``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roadsurf_tpu import production
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import RawForcing
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model, scan_steps
from roadsurf_tpu.ops import pallas_step as ps
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda pytest -m gpu)")


@pytest.mark.parametrize("scenario", ["winter_mix", "cold_snow"])
def test_compiled_kernel_matches_scan(gpu, scenario):
    """Every forcing layout, compiled, against the XLA scan at the CPU
    tests' tolerance; the layouts agree bitwise."""
    P, T = 16384, 256
    model = Model(ModelSettings(sim_len=T, dt=30.0))
    raw, cal = synthetic_raw(P, T, seed=21, scenario=scenario,
                             dtype=np.float32)
    pts = default_point_params(P)
    prep = model.prepare(raw, pts, cal)
    prep = prep._replace(**{k: jnp.asarray(getattr(prep, k), jnp.float32)
                            for k in ("tair", "vz", "rhz", "rain", "snow",
                                      "sw", "lw", "tsurf_obs", "trf_fric")})
    state = model.init(raw, cal, dtype=jnp.float32)
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)
    final_ref, out_ref = jax.jit(lambda s, p: scan_steps(
        s, p, ones, ones, obs, model.cfg, model.grid, model.params))(
            state, prep)

    tmp0, scal0 = ps.pack_state(state)
    full = ps.pack_forcing(prep, ones, ones, obs)
    tm = jnp.transpose(full.reshape(T, ps.NCH, -1, ps.SUBL, ps.LANE),
                       (2, 0, 1, 3, 4))
    slim = tm[:, :, list(ps.SLIM_CHANNELS)]
    aux = jnp.stack([jnp.zeros_like(obs)] * 3 + [obs])
    run = jax.jit(lambda t, s, f, **kw: ps.pallas_scan(
        t, s, f, model.cfg, model.params, model.grid, **kw))
    outs = [run(tmp0, scal0, full), run(tmp0, scal0, tm),
            run(tmp0, scal0, slim, slim_trf=prep.trf_fric, aux_rows=aux)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tmp_f, scal_f, out = outs[0]
    final = ps.unpack_state(tmp_f, scal_f, model.grid.nlayers, state)
    np.testing.assert_allclose(np.asarray(final.tmp),
                               np.asarray(final_ref.tmp),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out[:, 0]),
                               np.asarray(out_ref.tsurf),
                               rtol=2e-5, atol=2e-4)
    for k, name in enumerate(("wat", "snow", "ice", "ice2", "dep"), 1):
        np.testing.assert_allclose(np.asarray(out[:, k]),
                                   np.asarray(getattr(out_ref, name)),
                                   rtol=2e-5, atol=2e-3, err_msg=name)


def test_streamed_engine_compiled(gpu):
    """The station-fed production engine runs the compiled kernel (no
    interpreter) and matches the scan engine."""
    S, P, T = 16, 16384, 193
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False,
                             output_step_minutes=30)
    model = Model(settings)
    raw_st, cal = synthetic_raw(S, T, seed=5, scenario="winter_mix",
                                dtype=np.float32)
    st_idx = np.arange(P) % S
    raw_pt = RawForcing(*(np.asarray(getattr(raw_st, n))[st_idx]
                          for n in RawForcing._fields))
    pts = default_point_params(P)
    mesh = make_mesh()
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": settings, "params": model.params,
           "hour": cal.hour, "t_total": T}
    exp = production.StationExpander(raw_st, st_idx, mesh, chunk_t=64,
                                     prep_ctx=ctx)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    eng = production._Engine(model, exp, pts, cal, state0, mesh=mesh,
                             chunk_t=64)
    assert eng.interpret is False and eng.fused
    res = production.run_production(model, exp, pts, cal, state0,
                                    mesh=mesh, chunk_t=64)
    _, out_ref = model.run(raw_pt, pts, cal)
    want = np.asarray(out_ref.tsurf)[::settings.output_stride]
    np.testing.assert_allclose(res.fields["tsurf"], want,
                               rtol=2e-5, atol=2e-4)
