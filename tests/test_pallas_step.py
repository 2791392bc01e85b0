"""Pallas fused-scan kernel parity vs the XLA-scan path (float32 vs float32,
interpret mode on CPU; the compiled GPU path is exercised by the gpu-marked
tests and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model, scan_steps
from roadsurf_tpu.ops import pallas_step as ps
from roadsurf_tpu.state import default_point_params


def _run_pair(scenario="winter_mix", sim_len=128, npoints=1024, seed=21,
              out_stride=1):
    settings = ModelSettings(sim_len=sim_len, dt=30.0)
    model = Model(settings)
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed, scenario=scenario,
                             dtype=np.float32)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    prep = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), prep)
    # float32 everywhere for an apples-to-apples comparison
    prep = prep._replace(**{k: jnp.asarray(getattr(prep, k), jnp.float32)
                            for k in ("tair", "vz", "rhz", "rain", "snow",
                                      "sw", "lw", "tsurf_obs", "trf_fric")})
    state = model.init(raw, cal, dtype=jnp.float32)
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)

    final_ref, out_ref = scan_steps(state, prep, ones, ones, obs, model.cfg,
                                    model.grid, model.params)

    tmp0, scal0 = ps.pack_state(state)
    forcing = ps.pack_forcing(prep, ones, ones, obs)
    tmp_f, scal_f, out = ps.pallas_scan(
        tmp0, scal0, forcing, model.cfg, model.params, model.grid,
        out_stride=out_stride, interpret=True)
    final_pal = ps.unpack_state(tmp_f, scal_f, settings.nlayers, state)
    return final_ref, out_ref, final_pal, out, out_stride


@pytest.mark.parametrize("scenario", ["winter_mix", "cold_snow"])
def test_pallas_matches_scan(scenario):
    final_ref, out_ref, final_pal, out, stride = _run_pair(scenario=scenario)
    np.testing.assert_allclose(np.asarray(final_pal.tmp),
                               np.asarray(final_ref.tmp),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out[:, 0, :]),
                               np.asarray(out_ref.tsurf),
                               rtol=2e-5, atol=2e-4)
    for k, name in ((1, "wat"), (2, "snow"), (3, "ice"), (4, "ice2"),
                    (5, "dep")):
        np.testing.assert_allclose(np.asarray(out[:, k, :]),
                                   np.asarray(getattr(out_ref, name)),
                                   rtol=2e-5, atol=2e-3, err_msg=name)


def test_pallas_output_stride():
    final_ref, out_ref, final_pal, out, _ = _run_pair(out_stride=4,
                                                      sim_len=128)
    np.testing.assert_allclose(np.asarray(out[:, 0, :]),
                               np.asarray(out_ref.tsurf)[::4],
                               rtol=2e-5, atol=2e-4)


def _folded_cases(dt):
    """(reference expression as physics/ writes it, the kernel's constant
    factor for it) for every constant chain the kernel folds itself."""
    p = Model(ModelSettings(sim_len=8, dt=dt)).params
    tph = ModelSettings(dt=dt).tph
    heat = p.wat_m_heat * p.wat_dens
    s2i = 0.25 / (0.2 + 0.25)
    return {
        "melt_mm": (lambda x: 1000.0 * (x * dt) / heat,
                    ps._fold(ps._fold(1000.0, dt), ps._recip(heat))),
        "melt_heat": (lambda x: heat * (x / 1000.0) / dt,
                      ps._fold(ps._fold(heat, ps._recip(1000.0)),
                               ps._recip(dt))),
        "wat_wear": (lambda x: 10.0 * x * tph, ps._fold(10.0, tph)),
        "snow_to_ice": (lambda x: s2i * (x * tph), ps._fold(s2i, tph)),
        "albedo": (lambda x: (x / 1.5) * (p.alb_snow - p.alb_dry),
                   ps._fold(ps._recip(1.5), p.alb_snow - p.alb_dry)),
        "per_dt": (lambda x: x / dt, ps._recip(dt)),
        "evap": (lambda x: x * 1000.0 * dt, ps._fold(1000.0, dt)),
    }


@pytest.mark.parametrize("dt", [30.0, 60.0])
@pytest.mark.parametrize("name", sorted(_folded_cases(30.0)))
def test_kernel_folds_constants_as_xla(name, dt):
    """XLA compiles ``x / c`` as ``x * (1 / c)`` and folds a chain of
    constant factors into one; Triton keeps the source form.  The kernel
    writes the folded factor itself, so the compiled kernel rounds as the
    XLA reference does: x times the kernel's factor (numpy, no XLA) equals
    the reference expression compiled by XLA, bit for bit."""
    ref_fn, factor = _folded_cases(dt)[name]
    assert isinstance(factor, np.float32)
    x = np.random.default_rng(3).uniform(0.0, 500.0, 4096).astype(np.float32)
    got = x * factor
    want = np.asarray(jax.jit(ref_fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
