"""The physics triad (oracle / scan step / Pallas kernel) must stay in
lockstep for EVERY physics feature flag.

Physics intentionally lives in three places (CLAUDE.md invariant):
  * ``oracle.py``      -- scalar float64, control-flow-literal ground truth
  * ``step.py``        -- the vectorized XLA step
  * ``ops/pallas_step.py`` -- the fused GPU kernel
Any physics change must land in all three.  This test is the tripwire: for
every flag combination below, oracle == scan at 1e-9 (float64) and
kernel == scan at float32 round-off.  ADDING A ModelSettings FIELD FAILS
``test_settings_fields_accounted`` until the new flag is classified here --
either added to FLAG_COMBOS (physics-bearing) or to NON_PHYSICS_FIELDS.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roadsurf_tpu.config import ModelSettings, PhysicsParams
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model, scan_steps
from roadsurf_tpu.ops import pallas_step as ps
from roadsurf_tpu.oracle import Oracle, OraclePoint
from roadsurf_tpu.state import default_point_params

# fields that do not alter single-point uncoupled step physics (run
# geometry, coupling/relaxation drivers covered by their own parity suites)
NON_PHYSICS_FIELDS = {
    "sim_len", "dt", "nlayers", "coupling_minutes",
    "coupling_effect_reduction", "output_step_minutes", "use_coupling",
    "use_relaxation",
}

# every physics-bearing flag appears toggled in at least one combo
FLAG_COMBOS = [
    {},
    {"force_snow_melting": True, "force_ice_melting": True},
    {"melting_can_change_temperature": False},
    {"force_tsurf": True},
    {"tsurf_output_depth": 0.03},
]


def test_settings_fields_accounted():
    covered = NON_PHYSICS_FIELDS | {
        k for combo in FLAG_COMBOS for k in combo}
    fields = {f.name for f in dataclasses.fields(ModelSettings)}
    missing = fields - covered
    assert not missing, (
        f"ModelSettings gained physics-relevant field(s) {sorted(missing)}: "
        "mirror the physics in oracle.py, step.py AND ops/pallas_step.py, "
        "then add a FLAG_COMBOS entry here (or whitelist in "
        "NON_PHYSICS_FIELDS if it cannot affect step physics)")


@pytest.mark.parametrize("combo", FLAG_COMBOS,
                         ids=lambda c: "+".join(c) or "defaults")
def test_triad_lockstep(combo):
    sim_len, npoints = 240, 256      # sim_len divisible by the kernel chunk
    settings = ModelSettings(sim_len=sim_len, dt=30.0, **combo)
    model = Model(settings)
    raw, cal = synthetic_raw(npoints, sim_len, seed=31,
                             scenario="winter_mix")
    pts = default_point_params(npoints)

    # scan engine, float64
    _, out = model.run(raw, pts, cal)

    # oracle, scalar float64 (two spot points)
    oracle = Oracle(settings, PhysicsParams())
    for pnt in (0, npoints // 2):
        f = {k: np.array(getattr(raw, k)[pnt], np.float64)
             for k in ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw",
                       "sw_dir", "lw_net", "tsurf_obs")}
        f["prec_phase"] = np.array(raw.prec_phase[pnt])
        ref = oracle.run(f, cal, OraclePoint())
        got = np.stack([np.asarray(getattr(out, k))[:, pnt]
                        for k in ("tsurf", "wat", "snow", "ice", "ice2",
                                  "dep")], axis=-1)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9,
                                   err_msg=f"oracle vs scan, {combo}")

    # Pallas kernel (interpret), float32, vs float32 scan
    raw32 = jax.tree.map(lambda x: np.asarray(x, np.float32)
                         if np.asarray(x).dtype.kind == "f" else x, raw)
    prep = model.prepare(raw32, pts, cal)
    prep = prep._replace(**{k: jnp.asarray(getattr(prep, k), jnp.float32)
                            for k in ("tair", "vz", "rhz", "rain", "snow",
                                      "sw", "lw", "tsurf_obs", "trf_fric")})
    state = model.init(raw32, cal, dtype=jnp.float32, pts=pts)
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)
    final32, out32 = scan_steps(state, prep, ones, ones, obs, model.cfg,
                                model.grid, model.params)
    depth = model.depth_arrays(pts, jnp.float32)
    tmp0, scal0 = ps.pack_state(state)
    forcing = ps.pack_forcing(prep, ones, ones, obs)
    tmp_f, scal_f, pout = ps.pallas_scan(
        tmp0, scal0, forcing, model.cfg, model.params, model.grid,
        out_stride=1, interpret=True)
    np.testing.assert_allclose(np.asarray(pout[:, 0, :]),
                               np.asarray(out32.tsurf),
                               rtol=2e-5, atol=2e-4,
                               err_msg=f"kernel vs scan tsurf, {combo}")
    for k, name in ((1, "wat"), (2, "snow"), (3, "ice"), (4, "ice2"),
                    (5, "dep")):
        np.testing.assert_allclose(np.asarray(pout[:, k, :]),
                                   np.asarray(getattr(out32, name)),
                                   rtol=2e-5, atol=2e-3,
                                   err_msg=f"kernel vs scan {name}, {combo}")
