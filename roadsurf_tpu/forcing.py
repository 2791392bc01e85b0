"""Forcing preparation: one vectorized [P, T] pass over the weather inputs.

The reference evaluates input validation, relaxation smoothing, precipitation
typing, solar position and sky-view radiation correction scalar-per-step
inside the time loop (examples/example1/src/Simulation.f90:58-95).  All of
those are pure functions of (forcing, time, location) -- none touch prognostic
state -- so a TPU-native design hoists them out of the sequential scan into a
single fused batched pass here.  The scan step then only consumes the
channels in :class:`Prepared`.

Index conventions: step t (0-based) corresponds to the reference's 1-based
loop index i = t + 1 and consumes forcing row t.  The final step t = T-1
replicates the reference's ``lastValues`` quirks (no CheckValues, no
relaxation, no obs forcing, frozen coupling flags;
examples/example1/src/Simulation.f90:100-113, src/InputOutput.f90:169-198).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .config import ModelSettings, PhysicsParams, MISSING
from .physics import storage
from .physics.radiation import modify_radiation
from .physics.sun import elevation_azimuth, julian_ephemeris_day
from .state import PointParams


class Calendar(NamedTuple):
    """Per-step UTC calendar of the simulation grid, [T] int arrays."""
    year: np.ndarray
    month: np.ndarray
    day: np.ndarray
    hour: np.ndarray
    minute: np.ndarray
    second: np.ndarray

    @classmethod
    def from_epochs(cls, epochs: np.ndarray) -> "Calendar":
        dt64 = np.asarray(epochs, dtype="datetime64[s]")
        y = dt64.astype("datetime64[Y]").astype(int) + 1970
        mo = dt64.astype("datetime64[M]").astype(int) % 12 + 1
        d = (dt64.astype("datetime64[D]") - dt64.astype("datetime64[M]")).astype(int) + 1
        h = (dt64.astype("datetime64[h]") - dt64.astype("datetime64[D]")).astype(int)
        mi = (dt64.astype("datetime64[m]") - dt64.astype("datetime64[h]")).astype(int)
        s = (dt64.astype("datetime64[s]") - dt64.astype("datetime64[m]")).astype(int)
        return cls(y, mo, d, h, mi, s)

    @classmethod
    def from_start(cls, start_epoch: int, dt: float, sim_len: int) -> "Calendar":
        epochs = start_epoch + (np.arange(sim_len) * dt).astype(np.int64)
        return cls.from_epochs(epochs)

    @property
    def jde(self) -> np.ndarray:
        return julian_ephemeris_day(self.year, self.month, self.day,
                                    self.hour, self.minute, self.second)


def valid_threshold(name: str) -> float:
    """Per-variable overlay validity threshold (DataHandler per-value merge,
    examples/example1/src/DataHandler.cpp:73-82): values above it are
    present.  lw_net is a NET flux and legitimately negative
    (src/InputArrays.f90.inc missing sentinel -9999.9 vs physical range)."""
    return -1000.0 if name == "lw_net" else -100.0


class RawForcing(NamedTuple):
    """Interpolated-to-grid weather inputs, [P, T] float (missing = -9999.9
    except lw_net whose missing threshold is -1000; src/InputArrays.f90.inc)."""
    tair: jnp.ndarray
    tdew: jnp.ndarray
    vz: jnp.ndarray
    rhz: jnp.ndarray
    prec: jnp.ndarray       #: mm/h
    sw: jnp.ndarray
    lw: jnp.ndarray
    sw_dir: jnp.ndarray
    lw_net: jnp.ndarray
    tsurf_obs: jnp.ndarray
    prec_phase: jnp.ndarray  #: int codes, missing = -9999


class Prepared(NamedTuple):
    """Scan-ready forcing, time-major [T, P] (plus [T] shared channels)."""
    tair: jnp.ndarray
    vz: jnp.ndarray          #: relaxed + calm-limit floored
    rhz: jnp.ndarray
    rain: jnp.ndarray        #: mm added to water storage this step
    snow: jnp.ndarray        #: mm added to snow storage this step
    sw: jnp.ndarray          #: effective SW (sky-view modified)
    lw: jnp.ndarray          #: effective LW
    tsurf_obs: jnp.ndarray   #: obs to force into the profile, else -9999.9
    valid: jnp.ndarray       #: bool, CheckValues outcome
    in_coupling: jnp.ndarray  #: bool, melting-guard coupling phase flag
    trf_fric: jnp.ndarray    #: [T] traffic friction heat


def relax_anchors(raw: RawForcing, pts: PointParams):
    """Relaxation anchor values (X_initEnd, src/Relaxation.f90:10-47): the
    forcing at the 0-based anchor step init_len-1, with the first-step wind
    floor applied first (Initialization.f90:121-123).  raw: [P, T];
    returns ([P] tair, vz, rhz).

    numpy in -> numpy out (the ingest data plane must stay device-free so
    it never goes through the device); jax in -> jnp out."""
    import jax
    if not isinstance(raw.tair, jax.Array):
        tair = np.asarray(raw.tair)
        vz = np.array(raw.vz)
        rhz = np.asarray(raw.rhz)
        vz[..., 0] = np.maximum(vz[..., 0], 0.4)
        t0 = np.maximum(np.asarray(pts.init_len, np.int64) - 1, 0)[..., None]
        anchor = lambda x: np.take_along_axis(x, t0, axis=-1)[..., 0]
        return anchor(tair), anchor(vz), anchor(rhz)
    tair = jnp.asarray(raw.tair)
    vz = jnp.asarray(raw.vz)
    rhz = jnp.asarray(raw.rhz)
    vz = vz.at[..., 0].set(jnp.maximum(vz[..., 0], 0.4))
    t0 = jnp.maximum(jnp.asarray(pts.init_len, jnp.int32) - 1, 0)[..., None]
    anchor = lambda x: jnp.take_along_axis(x, t0, axis=-1)[..., 0]
    return anchor(tair), anchor(vz), anchor(rhz)


def prepare_window(rawT: RawForcing, pts: PointParams, hour, settings, p,
                   t_offset=0, t_total: int = None, anchors=None, jde=None,
                   use_relaxation: Optional[jnp.ndarray] = None,
                   enable_skyview: bool = False,
                   flat_horizons: bool = False,
                   time_axis: int = 0) -> Prepared:
    """Window-parameterized, time-major forcing preparation (jit-safe).

    The production engine streams forcing in time chunks (the full [T, P]
    tensor never exists, SURVEY.md section 6); every step-dependent rule here
    is written analytically in the GLOBAL step index, so chunked calls
    compose to exactly ``prepare``'s output (tests/test_forcing_window.py).

    rawT: RawForcing with TIME-MAJOR [Tc, P] leaves covering global steps
    [t_offset, t_offset + Tc); hour: [Tc] UTC hours; t_total: full simulation
    length T (for the first/last-step quirks); anchors: the
    ``relax_anchors`` triple (required when settings.use_relaxation);
    jde: [Tc] julian ephemeris day (required when ``enable_skyview``).

    ``time_axis``: position of the time axis in the rawT leaves; remaining
    axes are point axes of any shape, with pts/anchors leaves shaped to
    match (the fused tile-major production path calls this with
    [n_tiles, Tc, subl, LANE] leaves and time_axis=1 -- every rule is
    elementwise over points, so the prepared channels land directly in the
    Pallas kernel's tile-major layout with no transposes).  Sky view
    requires the default [Tc, P] layout.
    """
    ta = time_axis
    nd = jnp.asarray(rawT.tair).ndim
    Tc = rawT.tair.shape[ta]
    dtype = rawT.tair.dtype
    t_idx = t_offset + jnp.arange(Tc)             # [Tc] global step index

    def tb(x):                                    # [Tc] broadcast helper
        x = jnp.asarray(x)
        return x.reshape((1,) * ta + (Tc,) + (1,) * (nd - ta - 1))

    def pvec(x):                                  # point-shaped broadcast
        return jnp.expand_dims(jnp.asarray(x), ta)

    last = tb(t_idx == t_total - 1)               # the lastValues step

    skyview_active = (pts.sky_view < 1.0) & (pts.sky_view > -0.01)

    # --- CheckValues (src/InputOutput.f90:45-84); the final step skips it
    # (Simulation.f90:100-113) --------------------------------------------
    ok = ((rawT.tair >= -90.0) & (rawT.tair <= 100.0)
          & (rawT.tdew >= -90.0) & (rawT.tdew <= 100.0)
          & (rawT.rhz >= -0.1) & (rawT.rhz <= 120.0)
          & (rawT.vz >= -1.0) & (rawT.vz <= 100.0)
          & (rawT.sw >= -0.1) & (rawT.sw <= 4000.0)
          & (rawT.lw >= -0.1) & (rawT.lw <= 1000.0)
          & (rawT.prec >= -0.1) & (rawT.prec <= 500.0))
    sky_ok = ((rawT.sw_dir >= -0.1) & (rawT.sw_dir <= 4000.0)
              & (rawT.lw_net >= -1000.0) & (rawT.lw_net <= 1000.0))
    ok = ok & (sky_ok | ~pvec(skyview_active))
    valid = ok | last

    # Initialization.f90:121-123 -- first wind value floored before anything
    vz = jnp.where(tb(t_idx == 0), jnp.maximum(rawT.vz, 0.4), rawT.vz)

    # CheckValues SW_dir <= SW clamp (InputOutput.f90:75-77); the last step
    # skips CheckValues, so the clamp is masked off there.
    sw_dir = jnp.where(last, rawT.sw_dir, jnp.minimum(rawT.sw_dir, rawT.sw))

    # --- sky view / local horizons (ModRadiation, applied per point where
    # 0 <= sky_view < 1; Simulation.f90:152-155) -------------------------
    sw, lw = rawT.sw, rawT.lw
    if enable_skyview:
        # elevation_azimuth / modify_radiation are elementwise over
        # (point, step), so they evaluate directly in the rawT layout --
        # [Tc, P] or tile-major -- with the same broadcast helpers as the
        # rest of the prep (horizons keep their 360-axis LAST; pvec lifts
        # each degree column into the layout)
        jde = jnp.asarray(jde, dtype=dtype)
        elev, azim = elevation_azimuth(tb(jde), pvec(pts.lat),
                                       pvec(pts.lon))
        sw_m, lw_m = modify_radiation(sw, sw_dir, lw, rawT.lw_net,
                                      elev, azim, pvec(pts.sky_view),
                                      pts.horizons, p,
                                      flat_horizons=flat_horizons,
                                      pexp=pvec)
        sw = jnp.where(pvec(skyview_active), sw_m, sw)
        lw = jnp.where(pvec(skyview_active), lw_m, lw)

    # --- relaxation (RelaxationOperations, src/Relaxation.f90:10-47) ----
    # NOTE: the reference also recomputes atm%TDew from the relaxed Tair/Rhz
    # (src/Relaxation.f90:46), but atm%TDew is a dead store -- nothing in the
    # physics reads it (it is only ever assigned: InputOutput.f90:108,183,
    # Relaxation.f90:46), and example2's writer outputs the INPUT tdew array
    # (QueryDataTools.cpp:334-336).  So no Tdew recompute is needed here; the
    # boundary layer consumes rhz directly.
    tair, rhz = rawT.tair, rawT.rhz
    relax_valid = ((pts.tair_relax >= -100.0) & (pts.tair_relax <= 100.0)
                   & (pts.vz_relax >= 0.0) & (pts.vz_relax <= 100.0)
                   & (pts.rh_relax >= 0.0) & (pts.rh_relax <= 110.0))
    if use_relaxation is None:
        use_relaxation = jnp.asarray(settings.use_relaxation)
    relax_on = relax_valid & use_relaxation
    if settings.use_relaxation:
        assert anchors is not None, "relaxation requires relax_anchors()"
        tair_a, vz_a, rhz_a = anchors
        t0 = pvec(pts.init_len - 1)               # 0-based anchor step
        tcol = tb(t_idx)
        # adjustment applies for 1-based i > InitLenI, i.e. t >= init_len,
        # and never to the final step (lastValues)
        adj_mask = (tcol >= t0 + 1) & (~last) & pvec(relax_on)
        decay = jnp.exp(-(settings.dt * (tcol - t0)) / (4.0 * 3600.0))
        tair = jnp.where(adj_mask,
                         tair - (pvec(pts.tair_relax) - pvec(tair_a)) * decay,
                         tair)
        vz = jnp.where(adj_mask,
                       vz - (pvec(pts.vz_relax) - pvec(vz_a)) * decay, vz)
        rhz_adj = rhz - (pvec(pts.rh_relax) - pvec(rhz_a)) * decay
        rhz = jnp.where(adj_mask, jnp.minimum(rhz_adj, 100.0), rhz)

    # --- day/night traffic + wind floor (SetDayDependendVariables,
    # src/BalanceModel.f90:354-387) --------------------------------------
    hour = jnp.asarray(hour)
    is_night = (hour >= p.night_on) | (hour <= p.night_off)
    calm_lim = jnp.where(is_night, p.calm_lim_ngt, p.calm_lim_day).astype(dtype)
    trf_fric = jnp.where(is_night, p.trf_fric_ngt, p.trf_fric_day).astype(dtype)
    vz = jnp.maximum(vz, tb(calm_lim))

    # --- precipitation typing (pure in forcing after relaxation) --------
    prec_step = rawT.prec / 3600.0 * settings.dt  # SetCurrentValues :111
    rain, snow, _ = storage.calc_prec_type(rawT.prec_phase, prec_step,
                                           tair, rhz, p)

    # --- obs forcing of the surface temperature (SetCurrentValues,
    # src/InputOutput.f90:116-148) ---------------------------------------
    tcol = tb(t_idx)
    in_init = (tcol + 1) <= pvec(pts.init_len)
    force_phase = in_init | bool(settings.force_tsurf)
    coupling_on = ((pts.coupling_end >= 1)
                   & (pts.coupling_tsurf > -100.0)
                   & settings.use_coupling)
    before_window = (~pvec(coupling_on)) | ((tcol + 1) < pvec(pts.coupling_start))
    obs_ok = rawT.tsurf_obs > -100.0
    forced = force_phase & obs_ok & before_window & (~last)
    tsurf_obs = jnp.where(forced, rawT.tsurf_obs, MISSING)

    # --- coupling-phase flag for the melting guard ----------------------
    # the final step keeps the previous flag (no CouplingOperations1 there):
    # the flag is analytic in t, so the last step evaluates it at t-1.
    te = jnp.where((t_idx == t_total - 1) & (t_total >= 2), t_idx - 1, t_idx)
    tecol = tb(te)
    in_coupling = (pvec(coupling_on)
                   & ((tecol + 1) >= pvec(pts.coupling_start))
                   & ((tecol + 1) <= pvec(pts.coupling_end)))

    f = lambda x: jnp.asarray(x, dtype=dtype)
    return Prepared(
        tair=f(tair), vz=f(vz), rhz=f(rhz), rain=f(rain), snow=f(snow),
        sw=f(sw), lw=f(lw), tsurf_obs=f(tsurf_obs),
        valid=valid, in_coupling=in_coupling, trf_fric=trf_fric,
    )


def prepare(raw: RawForcing, pts: PointParams, cal: Calendar,
            settings: ModelSettings, p: PhysicsParams,
            use_relaxation: Optional[jnp.ndarray] = None) -> Prepared:
    """Build the prepared forcing tensor.  All inputs [P, T]; output [T, P].

    Thin wrapper over :func:`prepare_window` with the full [0, T) window."""
    raw = RawForcing(*(jnp.asarray(x) for x in raw))
    pts = PointParams(*(jnp.asarray(x) for x in pts))
    T = raw.tair.shape[-1]
    dtype = raw.tair.dtype

    from .parallel.distributed import host_any
    skyview_active = (pts.sky_view < 1.0) & (pts.sky_view > -0.01)
    enable_skyview = host_any(skyview_active)
    anchors = relax_anchors(raw, pts) if settings.use_relaxation else None
    jde = jnp.asarray(cal.jde, dtype=dtype) if enable_skyview else None
    rawT = RawForcing(*(jnp.swapaxes(x, -1, 0) for x in raw))
    return prepare_window(rawT, pts, jnp.asarray(cal.hour), settings, p,
                          t_offset=0, t_total=T, anchors=anchors, jde=jde,
                          use_relaxation=use_relaxation,
                          enable_skyview=enable_skyview)


def cof_window(sw_corr, lw_corr, coupling_end, t_offset: int, tc: int,
               T: int, settings: ModelSettings, dtype=jnp.float64):
    """Post-window radiation-coefficient rows [t_offset, t_offset+tc)
    (0-based rows; row t = 1-based step t+1), valid only for rows at/after
    every point's coupling_end.

    Replicates the per-point-PC carry exactly (src/Coupling.f90:82-88 plus
    the final-step freeze): the final step reuses the step-(T-1) value, which
    for a window ending at T-1 is the *undecayed* trial coefficient
    (dec(end)=1), not 1.0."""
    rows = t_offset + jnp.arange(tc)
    i = rows + 1
    i_eff = jnp.where((rows == T - 1) & (T >= 2), i - 1, i)      # lastValues
    end = jnp.asarray(coupling_end)[None, :]
    dts = settings.dt
    expo = -((dts * i_eff.astype(dtype))[:, None]
             - dts * end.astype(dtype)) / settings.coupling_effect_reduction
    dec = jnp.exp(jnp.minimum(expo, 0.0))
    on = (i_eff[:, None] >= end) & (end >= 1)
    sw = jnp.where(on, 1.0 + sw_corr[None, :] * dec, 1.0)
    lw = jnp.where(on, 1.0 + lw_corr[None, :] * dec, 1.0)
    return sw.astype(dtype), lw.astype(dtype)


def cof_schedule(sw_correction, lw_correction, coupling_end, T: int,
                 settings: ModelSettings, dtype=jnp.float64):
    """Post-coupling radiation coefficient decay schedule
    (CouplingOperations1, src/Coupling.f90:82-88): per (T, P) arrays of
    SwRadCof/LwRadCof.  Before/at the window end the coefficients are 1 (the
    in-window values are handled by the coupling driver).  The final step
    repeats the previous step's value (no CouplingOperations1 there)."""
    t_idx = jnp.arange(T)[:, None]
    end = jnp.asarray(coupling_end)[None, :]
    dts = settings.dt
    decay = jnp.exp(-((dts * (t_idx + 1)) - (dts * end))
                    / settings.coupling_effect_reduction)
    after = (t_idx + 1) > end
    sw = jnp.where(after & (end >= 1), 1.0 + sw_correction[None, :] * decay, 1.0)
    lw = jnp.where(after & (end >= 1), 1.0 + lw_correction[None, :] * decay, 1.0)
    if T >= 2:
        sw = sw.at[-1, :].set(sw[-2, :])
        lw = lw.at[-1, :].set(lw[-2, :])
    return sw.astype(dtype), lw.astype(dtype)
