"""float32 (perf mode) vs float64 (parity mode) drift over long horizons.

The reference is float64 end-to-end on CPU; the device perf path runs
float32.
SURVEY.md flags the Kelvin^4 radiation term and long-horizon drift as the
risks.  These tests quantify the drift over a 12 h window and bound it --
the acceptance criterion is drift well below the model's physical accuracy
(the coupling tolerance is 0.1 K; obs errors are several 0.1 K)."""
import jax
import jax.numpy as jnp
import numpy as np

from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model, scan_steps
from roadsurf_tpu.state import default_point_params


def _run(dtype, sim_len=2881, npoints=16, seed=33, scenario="winter_mix"):
    settings = ModelSettings(sim_len=sim_len, dt=30.0)
    model = Model(settings)
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed, scenario=scenario)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    prep = jax.tree.map(
        lambda x: x.astype(dtype) if x.dtype.kind == "f" else x, prep)
    state = model.init(raw, cal, dtype=dtype)
    ones = jnp.ones(prep.tair.shape, dtype)
    obs = jnp.asarray(pts.coupling_tsurf, dtype)
    _, out = scan_steps(state, prep, ones, ones, obs, model.cfg, model.grid,
                        model.params)
    return out


def test_f32_drift_bounded_24h():
    # Measured on this suite (2026-08): max |dTsurf| = 0.94 mK over the
    # full 24 h trajectory, 2.4 uK at the final step; storages <= 1.6e-4 mm.
    # The 2 mK bound pins the measurement (BASELINE.md "<1 mK" headline is
    # the measured value; the assert leaves ~2x headroom for compiler drift).
    out64 = _run(jnp.float64)
    out32 = _run(jnp.float32)
    dt_surf = np.abs(np.asarray(out64.tsurf) - np.asarray(out32.tsurf))
    assert dt_surf.max() < 2e-3, f"f32 tsurf drift {dt_surf.max():.6f} K"
    for name in ("wat", "snow", "ice", "dep"):
        d = np.abs(np.asarray(getattr(out64, name))
                   - np.asarray(getattr(out32, name)))
        assert d.max() < 1e-3, f"f32 {name} drift {d.max():.6f} mm"


def test_f32_drift_cold_24h():
    # measured max |dTsurf| = 6.6e-6 K over 24 h (cold_snow)
    out64 = _run(jnp.float64, scenario="cold_snow", seed=34)
    out32 = _run(jnp.float32, scenario="cold_snow", seed=34)
    dt_surf = np.abs(np.asarray(out64.tsurf) - np.asarray(out32.tsurf))
    assert dt_surf.max() < 1e-4, f"f32 tsurf drift {dt_surf.max():.6f} K"
