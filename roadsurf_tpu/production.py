"""Production-scale streamed execution: the operational nationwide run.

The reference's operational path is an async thread-pool driver over the full
data plane (examples/example2/src/roadrunner.cpp:595-719).  The device
re-design here:

 * compact forcing sources (station time series; NWP grids) ship to device
   ONCE, replicated; per-point forcing is expanded chunk by chunk ON DEVICE,
   sharded over the points mesh.  The full [T, P] forcing tensor (~568 GB at
   1M points, SURVEY.md section 6) never exists anywhere -- host, device or
   disk.
 * each streaming chunk is one fused jit: expand -> forcing.prepare_window ->
   pack_forcing -> shard_map'd whole-scan Pallas kernel
   (ops.pallas_step.pallas_scan; compiled through Triton on a GPU, run by
   the Pallas interpreter on the CPU backend).  Prognostic state stays on
   device in packed
   kernel layout between chunks (zero host round trips for state).
 * dispatch is pipelined two deep (block on chunk k-2) to hide the host
   dispatch round trip.
 * outputs are collected in-kernel at the output cadence and drained to host
   incrementally.
 * coupled runs (src/Coupling.f90) run the same streamed kernel up to the
   coupling window, execute the window with the iteration-major masked-scan
   engine (coupling.run_window_passes) in ONE device dispatch, then stream
   the remainder with the decayed radiation coefficients folded into the
   kernel's sw_cof/lw_cof forcing channels (forcing.cof_window).

This is the engine behind ``runner.py --engine pallas`` and
``bench_production.py``.
"""
from __future__ import annotations

import os
import time as timelib
import warnings
from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .config import MISSING
from .forcing import (Calendar, Prepared, RawForcing, cof_window,
                      prepare_window, relax_anchors, valid_threshold)
from .model import Model
from .observability import Progress, RunMetrics
from .ops import pallas_step as ps
from .parallel.sharding import POINTS, make_mesh, pallas_scan_sharded
from .state import PointParams, State

OUT_FIELD_ROWS = {"tsurf": ps.R_TSURF, "wat": ps.R_WAT, "snow": ps.R_SNOW,
                  "ice": ps.R_ICE, "ice2": ps.R_ICE2, "dep": ps.R_DEP}


def _to_host(x) -> np.ndarray:
    """Device -> host numpy; multi-process global arrays are allgathered
    (every host sees the full array -- tests/metrics only; the operational
    multi-host output path is ``drain='shard'`` + per-process writers, no
    full-array DCN gather)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def host_shard(x, axis: int):
    """This process's addressable rows of a global array along ``axis``:
    returns (local numpy, (lo, hi) global range).  The reference assembles
    output by disjoint-row writes into one shared object
    (examples/example2/src/QueryDataTools.cpp:299-345); across hosts the
    equivalent is each process pulling ONLY its own shard rows -- no DCN
    traffic -- and writing them with a range manifest
    (io.writer.write_shard_npz / merge_shards)."""
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        a = np.asarray(x)
        return a, (0, a.shape[axis])
    sh = sorted(x.addressable_shards,
                key=lambda s: s.index[axis].start or 0)
    lo = sh[0].index[axis].start or 0
    parts, cur = [], lo
    for s in sh:
        st = s.index[axis].start or 0
        if st != cur:
            raise ValueError(
                f"non-contiguous addressable shards along axis {axis}: "
                f"expected start {cur}, got {st}")
        d = np.asarray(s.data)
        parts.append(d)
        cur = st + d.shape[axis]
    return np.concatenate(parts, axis=axis), (lo, cur)


_INTERPRET_WARNED = False


def kernel_interpret(mesh) -> bool:
    """Whether the fused kernel runs in the Pallas interpreter on ``mesh``:
    compiled (Triton) on a GPU, interpreted on the CPU backend -- said once
    per process, as a warning -- and no kernel exists for other backends."""
    global _INTERPRET_WARNED
    platform = mesh.devices.flat[0].platform
    if platform == "gpu":
        return False
    if platform != "cpu":
        raise ValueError(
            f"the fused kernel has no {platform!r} build (gpu: compiled "
            f"through Triton; cpu: Pallas interpreter)")
    if not _INTERPRET_WARNED:
        _INTERPRET_WARNED = True
        warnings.warn("cpu backend: the fused kernel runs in the Pallas "
                      "interpreter (tests and small runs only)",
                      stacklevel=3)
    return True


def padded_points(n_points: int, mesh) -> int:
    """Points must divide the mesh and fill whole kernel lanes."""
    mult = int(np.prod(mesh.devices.shape)) * ps.LANE
    return -(-n_points // mult) * mult


def tile_geometry(n_points: int, mesh, tile_p: Optional[int] = None):
    """Kernel point-tile geometry ``(n_tiles, subl)`` shared by every fused
    tile-major forcing path, or None when the point count doesn't tile the
    mesh (each device block must hold whole kernel tiles)."""
    ndev = int(np.prod(mesh.devices.shape))
    if n_points % ndev:
        return None
    p_loc = n_points // ndev
    tp = tile_p or min(ps.TILE_P, p_loc)
    if p_loc % tp or tp % ps.LANE:
        return None
    return (n_points // tp, tp // ps.LANE)


#: shares of one device's memory (``device_bytes``) the streaming engine's
#: size rules may plan for: two in-flight forcing chunks, the fused
#: expansion's one-hot blocks, and the coupled driver's cached phase-B
#: window forcing
CHUNK_MEM_SHARE = 0.5
ONEHOT_MEM_SHARE = 0.125
WCACHE_MEM_SHARE = 0.25


def device_bytes(device=None) -> float:
    """Memory one device (default: this process's first) offers the
    process's arrays: the allocator's ``bytes_limit`` where the backend
    reports one (GPU), else the host's physical memory (the CPU backend
    reports no limit)."""
    device = device or jax.local_devices()[0]
    stats = device.memory_stats() or {}
    if stats.get("bytes_limit"):
        return float(stats["bytes_limit"])
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def auto_chunk_t(n_points: int, target_point_steps: int = 64 * 1048576,
                 max_chunk: int = 1024, min_chunk: int = 8) -> int:
    """Streaming chunk length: chunk_t * P is held near 64 steps x 1M points
    so each chunk dispatch carries enough device work to hide the host's
    dispatch and output drain; small point counts stream longer chunks, 1M+
    points stay at 64.  Capped so two in-flight point-major forcing chunks
    ([chunk_t, NCH, P] float32) fit CHUNK_MEM_SHARE of a device's memory
    (P counts every device's points: the cap is conservative on a mesh)."""
    tc = min(max_chunk, max(64, target_point_steps // max(n_points, 1)))
    per_step = 2 * max(n_points, 1) * ps.NCH * 4
    cap = int(CHUNK_MEM_SHARE * device_bytes() // per_step)
    return max(min_chunk, min(tc, cap))


def active_channels(raw: RawForcing):
    """Channel names carrying ANY non-sentinel value (host arrays).

    A channel is inactive only when every value IS the missing sentinel
    exactly -- then any expansion of it is a constant-sentinel broadcast,
    bitwise what the gather path would produce.  Shared by the raw
    tile-major expansion (only active channels ride the one-hot matmul)
    and the runner's chunk-size memory estimate."""
    out = []
    for n in RawForcing._fields:
        v = np.asarray(getattr(raw, n))
        sent = -9999 if n == "prec_phase" else MISSING
        if not np.all(v == np.asarray(sent, v.dtype)):
            out.append(n)
    return out


def raw_tm_chunk_t(chunk_t: int, n_points: int, n_active: int,
                   budget_bytes: Optional[float] = None,
                   floor: int = 16) -> int:
    """Streaming chunk length for raw-tm fused configs: the raw one-hot
    expansion materializes its active raw channels IN ADDITION to the slim
    stack, ~(n_active + NCH_SLIM) * 8 B per point-step with two chunks in
    flight -- halve (never below ``floor``) until those temporaries fit
    ``budget_bytes`` (default: CHUNK_MEM_SHARE of a device's memory)."""
    if budget_bytes is None:
        budget_bytes = CHUNK_MEM_SHARE * device_bytes()
    while (chunk_t > floor
           and n_points * chunk_t * 8 * (n_active + ps.NCH_SLIM)
           > budget_bytes):
        chunk_t = max(floor, chunk_t // 2)
    return chunk_t


def _pad_tail(x: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    """Edge-pad ``axis`` to length n."""
    x = np.asarray(x)
    rem = n - x.shape[axis]
    if rem <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, mode="edge")


class StationExpander:
    """On-device station->point forcing expansion.

    The data plane's station-keyed series ([S, T], a few thousand stations)
    replicate to every device; the nearest-station index map (the NearTree
    radius pattern, examples/example2/src/RoadSurfSource.cpp:516-616 /
    io.points.nearest_station_forcing) is sharded over points, so each chunk's
    [Tc, P] raw forcing materializes only as per-device blocks inside the
    chunk jit.

    Expander interface (shared with GridExpander / CompositeExpander):
    ``num_points`` / ``t_pad`` / ``dtype`` attributes, ``device_data`` (a
    pytree of device arrays passed as explicit jit arguments), and
    ``window(data, t0, tc) -> RawForcing [tc, P]`` whose only captured values
    are Python statics (never jax.Arrays -- closures lower to HLO constants).
    """

    #: fused-expansion station-window cap: a tile whose sorted points span
    #: more than this many station rows falls back to the gather fast path
    #: (the one-hot matmul cost scales linearly in SMAX).  When the default
    #: tile blows the cap, _plan_fused auto-tries halved tile sizes first --
    #: spans shrink proportionally.
    FUSED_SMAX_CAP = 512

    def __init__(self, raw_st: RawForcing, st_idx, mesh, chunk_t: int,
                 dtype=jnp.float32, prep_ctx: Optional[dict] = None,
                 fused: bool = True, tile_p: Optional[int] = None,
                 raw_tm: bool = False):
        st_idx = np.asarray(st_idx)
        self._fused_wanted = bool(fused)
        self._raw_tm_wanted = bool(raw_tm)
        self._fused_tile_p = tile_p        # None = kernel default (TILE_P)
        self.num_points = len(st_idx)
        self.mesh = mesh
        S, T = np.asarray(raw_st.tair).shape
        self.sim_len = T
        # one extra chunk of tail padding: phase boundaries of the coupled
        # driver start chunks at non-aligned offsets, so a window may overhang
        # T by up to chunk_t - 1 rows (masked off by the kernel's nsteps)
        t_pad = (-(-T // chunk_t) + 1) * chunk_t
        self.t_pad = t_pad
        rep = NamedSharding(mesh, P())
        shp = NamedSharding(mesh, P(POINTS))

        def put(x, dt):
            # stations-MAJOR [S, T_pad]: the per-chunk expansion then gathers
            # whole station rows (contiguous time slices) instead of scalar
            # elements along the minor axis.  NaN raws (an accepted missing marker elsewhere in the data
            # plane) become the sentinel HERE: one NaN in a raw_tm one-hot
            # matmul row would poison every point of its tile via 0*NaN
            # terms, and NaN/sentinel are indistinguishable downstream
            # (every validity rule is a > / range check NaN also fails)
            x = _pad_tail(np.asarray(x), t_pad, axis=1)     # [S, T_pad]
            x = np.asarray(x, dt)
            if x.dtype.kind == "f":
                x = np.where(np.isnan(x), np.asarray(MISSING, dt), x)
            return jax.device_put(x, rep)

        self.channels = RawForcing(
            *(put(getattr(raw_st, n),
                  np.int32 if n == "prec_phase" else dtype)
              for n in RawForcing._fields))
        ok = st_idx >= 0
        self.dtype = dtype
        self._raw_host = raw_st            # station-keyed [S, T] (no copy)
        self._ok_host = ok
        self._ie_host = np.where(ok, st_idx, 0)
        # first-step values per point (host, ORIGINAL point order), for
        # init_state / composites
        self.first_host = {
            n: np.where(ok, np.asarray(getattr(raw_st, n))[self._ie_host, 0],
                        -9999 if n == "prec_phase" else -9999.9)
            for n in RawForcing._fields}

        # ---- fused-expansion geometry (host math; device arrays later) --
        # Sorting points by station (within each device block) makes every
        # kernel tile's stations a small contiguous window, enabling the
        # on-device one-hot matmul expansion (see _build_prepared).  The
        # permutation is internal: device-side per-point arrays live in
        # SORTED order; host-facing interfaces (first_host, host_at) stay in
        # the caller's order, and the engine un-permutes outputs.
        self.point_perm = None             # sorted = original[perm]
        self.point_inv = None              # original j at sorted[inv[j]]
        self.tile_geom = None              # set when the raw-tm stack exists
        sidx_eff = np.where(ok, st_idx, S).astype(np.int32)
        if (prep_ctx is not None or raw_tm) and self._fused_wanted:
            self._plan_fused(sidx_eff, S)
        if self.point_perm is not None:
            st_idx = st_idx[self.point_perm]
            ok = ok[self.point_perm]

        self.ok = jax.device_put(ok, shp)
        self.st_idx = jax.device_put(
            np.where(ok, st_idx, 0).astype(np.int32), shp)

        # ---- station-level forcing preparation (the fast path) ----------
        # Every rule in forcing.prepare_window + the pack_forcing thermo is
        # a pure function of (series value, global step, per-SERIES params)
        # when relax/coupling parameters are station-derived and sky view is
        # inactive -- so it is computed ONCE at station rank [S+1, T_pad]
        # (tiny) instead of per point per chunk (512x duplicated work at
        # 2048 stations / 1M points).
        # Row S is a virtual all-MISSING station for out-of-radius points:
        # gathering its PREPARED values reproduces the garbage the generic
        # path computes from MISSING raws (non-finite garbage is sanitized
        # to the missing sentinel -- an inf/nan station row would poison
        # every point of a fused tile through the 0-weight matmul terms).
        self.prep_data = None
        if prep_ctx is not None:
            self._build_prepared(prep_ctx, rep, shp, st_idx, ok)
        # raw tile-major expansion (for CompositeExpander overlays: the
        # grid part needs RAW station values to merge with before prep)
        self._raw_tm = None
        if raw_tm and self.point_perm is not None:
            self._build_raw_tm(rep, S)

    def _plan_fused(self, sidx_eff, S):
        """Plan the fused MXU station->point expansion: per-device-block
        station sort, per-tile station windows, one-hot geometry.

        Sets point_perm/point_inv and the static window plan when feasible
        (a tile size that divides the device blocks AND keeps every tile's
        sorted station span within FUSED_SMAX_CAP / the one-hot memory budget);
        otherwise leaves them None (gather fast path).  When the default
        tile blows the span cap (dense station maps, e.g. ~10k stations at a
        few hundred k points), halved tile sizes are tried -- spans shrink
        with the tile."""
        from .ops import pallas_step as ps
        Pn = self.num_points
        ndev = int(np.prod(self.mesh.devices.shape))
        if Pn % ndev:
            return
        p_loc = Pn // ndev
        tile_p0 = self._fused_tile_p or min(ps.TILE_P, p_loc)
        if p_loc % tile_p0 or tile_p0 % ps.LANE:
            return
        perm = np.empty(Pn, np.int64)
        for d in range(ndev):
            off = d * p_loc
            perm[off:off + p_loc] = off + np.argsort(
                sidx_eff[off:off + p_loc], kind="stable")
        sidx_sorted = sidx_eff[perm]
        # the one-hot blocks (P * SMAX * 4 bytes) get ONEHOT_MEM_SHARE of a
        # device's memory
        oh_bytes = ONEHOT_MEM_SHARE * device_bytes()
        smax_cap = min(self.FUSED_SMAX_CAP,
                       int(oh_bytes / (4 * max(Pn, 1)) // 128) * 128)
        cands = [tile_p0]
        if self._fused_tile_p is None:       # auto-tune only when not pinned
            tp = tile_p0
            while tp // 2 >= ps.LANE and p_loc % (tp // 2) == 0:
                tp //= 2
                cands.append(tp)
        plan = None
        for tile_p in cands:
            n_tiles = Pn // tile_p
            tiles = sidx_sorted.reshape(n_tiles, tile_p)
            max_range = int((tiles[:, -1] - tiles[:, 0] + 1).max())
            smax = max(-(-max_range // 128) * 128, 128)
            if smax > smax_cap:
                continue
            s_pad = max(-(-(S + 1) // 128) * 128, smax)
            s_lo = np.clip(tiles[:, 0], 0, s_pad - smax).astype(np.int32)
            lidx = (sidx_sorted - np.repeat(s_lo, tile_p)).astype(np.int32)
            assert lidx.min() >= 0 and lidx.max() < smax
            plan = {"tile_p": tile_p, "n_tiles": n_tiles,
                    "smax": smax, "s_pad": s_pad, "s_lo": s_lo,
                    "lidx": lidx}
            break
        if plan is None:
            return
        self.point_perm = perm
        inv = np.empty(Pn, np.int64)
        inv[perm] = np.arange(Pn)
        self.point_inv = inv
        self._fused_plan = plan

    def _build_prepared(self, ctx, rep, shp, st_idx, ok):
        from .ops import pallas_step as ps
        settings, params = ctx["settings"], ctx["params"]
        st_pts = ctx["st_pts"]            # PointParams, rank S+1 (virtual!)
        anchors = ctx.get("anchors")      # triple [S+1] or None
        hour = _pad_tail(np.asarray(ctx["hour"], np.int32), self.t_pad)
        t_total = int(ctx["t_total"])
        dtype = self.dtype

        def _prep(channels: RawForcing, pts_l, anch):
            def app(x, name):
                miss = -9999 if name == "prec_phase" else jnp.asarray(
                    MISSING, x.dtype)
                return jnp.concatenate(
                    [x, jnp.full((1, x.shape[1]), miss, x.dtype)])
            rawv = RawForcing(*(app(getattr(channels, n), n)
                                for n in RawForcing._fields))
            rawT = RawForcing(*(x.T for x in rawv))        # [T_pad, S+1]
            prep = prepare_window(
                rawT, pts_l, jnp.asarray(hour), settings, params,
                t_offset=0, t_total=t_total, anchors=anch,
                enable_skyview=False)
            # sanitize non-finite garbage (MISSING-raw thermodynamics can
            # overflow, e.g. esat(-9999.9) = inf): affected (station, step)
            # entries are invalid anyway (C_VALID = 0 fails the point), and
            # a non-finite value in ANY station row of a fused tile's window
            # would poison every point of the tile via the matmul's
            # 0 * inf = nan terms
            def fin(x):
                x = jnp.asarray(x, jnp.float32)
                return jnp.where(jnp.isfinite(x), x, jnp.float32(MISSING))
            f32 = lambda x: fin(x).T                        # -> [S+1, T_pad]
            tair = jnp.asarray(prep.tair, jnp.float32)
            rhz = jnp.asarray(prep.rhz, jnp.float32)
            eair, airvcap = ps.forcing_thermo(tair, rhz)
            return ({ps.C_TAIR: f32(prep.tair), ps.C_VZ: f32(prep.vz),
                     ps.C_EAIR: fin(eair).T,
                     ps.C_AIRVCAP: fin(airvcap).T,
                     ps.C_RAIN: f32(prep.rain), ps.C_SNOW: f32(prep.snow),
                     ps.C_SW: f32(prep.sw), ps.C_LW: f32(prep.lw),
                     ps.C_TSURF_OBS: f32(prep.tsurf_obs),
                     ps.C_VALID: f32(prep.valid),
                     ps.C_INCPL: f32(prep.in_coupling)},
                    f32(prep.rhz),       # for the phase-B window provider
                    jnp.asarray(prep.trf_fric, jnp.float32))

        # cast exactly like _Engine's put_pts (fdt floats / int32 indices) so
        # station-level prep sees the same dtypes as the per-point path --
        # under x64 test mode a float64 param would change the rounding
        fdt = np.float32 if dtype == jnp.float32 else np.float64
        ints = {"init_len", "coupling_start", "coupling_end"}
        pts_dev = type(st_pts)(*(
            jax.device_put(np.asarray(
                getattr(st_pts, n), np.int32 if n in ints else fdt), rep)
            for n in st_pts._fields))
        anch_dev = (tuple(jax.device_put(np.asarray(a, fdt), rep)
                          for a in anchors) if anchors is not None else None)
        out_sh = jax.tree.map(lambda x: rep, jax.eval_shape(
            _prep, self.channels, pts_dev, anch_dev))
        chans, rhz_st, trf = jax.jit(_prep, out_shardings=out_sh)(
            self.channels, pts_dev, anch_dev)
        S = np.asarray(self._raw_host.tair).shape[0]
        self._prep_st_pts = st_pts         # host, rank S+1 (contract check)
        self.prep_data = {
            "ch": chans, "rhz": rhz_st, "trf": trf,
            "sidx": jax.device_put(
                np.where(ok, st_idx, S).astype(np.int32), shp)}
        if self.point_perm is not None:
            self._build_fused_arrays(rep, chans)

    def _plan_dev_arrays(self):
        """Per-tile one-hot blocks ``oh`` [n_tiles, SMAX, tile_p] (f32;
        selection by matmul at Precision.HIGHEST is bit-exact -- each output
        element is 1.0 * value + 0-terms) and station-window row indices
        ``widx`` [n_tiles, SMAX]; built once, shared by the slim (prepared)
        and raw fused stacks."""
        if getattr(self, "_oh", None) is not None:
            return self._oh, self._widx
        plan = self._fused_plan
        mesh = self.mesh
        smax = plan["smax"]
        n_tiles, tile_p = plan["n_tiles"], plan["tile_p"]
        lidx = jax.device_put(plan["lidx"],
                              NamedSharding(mesh, P(POINTS)))
        widx = jax.device_put(
            (plan["s_lo"][:, None]
             + np.arange(smax)[None, :]).astype(np.int32),
            NamedSharding(mesh, P(POINTS, None)))

        def build(lidx):
            return (jnp.arange(smax, dtype=jnp.int32)[None, :, None]
                    == lidx.reshape(n_tiles, 1, tile_p)).astype(jnp.float32)

        oh = jax.jit(build, out_shardings=NamedSharding(
            mesh, P(POINTS, None, None)))(lidx)
        self._oh, self._widx = oh, widx
        return oh, widx

    def _build_fused_arrays(self, rep, chans):
        """Device arrays for the fused one-hot expansion: the station-rank SLIM
        channel stack ``stf`` [T_pad, NCH_SLIM, S_pad] (only the
        (station, step)-varying channels -- the kernel sources TRF, the
        radiation cofs and the coupling obs elsewhere) plus the shared
        one-hot geometry."""
        from .ops import pallas_step as ps
        plan = self._fused_plan
        s_pad = plan["s_pad"]
        oh, widx = self._plan_dev_arrays()

        def build(chans):
            S1 = chans[ps.C_TAIR].shape[0]
            stf = jnp.stack([chans[c] for c in ps.SLIM_CHANNELS])
            stf = jnp.pad(stf, ((0, 0), (0, s_pad - S1), (0, 0)))
            return jnp.transpose(stf, (2, 0, 1))   # [t_pad, NCHS, s_pad]

        stf = jax.jit(build, out_shardings=rep)(chans)
        self.prep_data["fused"] = {"stf": stf, "oh": oh, "widx": widx}

    def _build_raw_tm(self, rep, S: int):
        """RAW channel stack [T_pad, n_active, S_pad] for the tile-major
        raw expansion (window_tm): row S is the virtual all-missing
        station, so out-of-radius points expand to the same sentinels
        window_from's ``ok`` mask produces.  Raw values are plain finite
        data (no thermo overflow), so no sanitization is needed before the
        one-hot matmul.

        Only ACTIVE channels (any valid value anywhere) ride the stack and
        the matmul: the operational composite's station part carries only
        tsurf_obs (obs overlaying an NWP grid forecast,
        examples/example2/src/roadrunner.cpp:763-792), so the expansion
        shrinks 11x and the overlay merge of the constant-missing channels
        constant-folds away."""
        plan = self._fused_plan
        s_pad = plan["s_pad"]
        oh, widx = self._plan_dev_arrays()
        active = active_channels(self._raw_host)

        def build(channels):
            rows = []
            for n in active:
                x = jnp.asarray(getattr(channels, n), jnp.float32)
                miss = -9999.0 if n == "prec_phase" else float(MISSING)
                x = jnp.concatenate(
                    [x, jnp.full((1, x.shape[1]), miss, jnp.float32)])
                rows.append(x)
            stf = jnp.stack(rows)                  # [n_active, S+1, T_pad]
            stf = jnp.pad(stf, ((0, 0), (0, s_pad - (S + 1)), (0, 0)))
            return jnp.transpose(stf, (2, 0, 1))   # [T_pad, n_act, s_pad]

        self._raw_tm = {"oh": oh, "widx": widx}
        if active:
            self._raw_tm["stf"] = jax.jit(build, out_shardings=rep)(
                self.channels)
        self._raw_tm_active = active
        self.tile_geom = (plan["n_tiles"], plan["tile_p"] // ps.LANE)

    def window_tm(self, data, t0, tc: int) -> RawForcing:
        """Tile-major RAW forcing [n_tiles, tc, subl, LANE] per field via
        the one-hot matmul expansion (bit-exact selection); flat point order =
        the SORTED order (point_perm), matching every other device-side
        per-point array of this expander.  Inactive channels (no valid
        value at any station) are constant-missing broadcasts."""
        from .ops import pallas_step as ps
        plan = self._fused_plan
        fd = data["tm"]
        active = self._raw_tm_active
        smax, n_tiles, tile_p = plan["smax"], plan["n_tiles"], plan["tile_p"]
        subl = tile_p // ps.LANE
        oshape = (n_tiles, tc, subl, ps.LANE)
        leaves = {n: (jnp.full(oshape, -9999, jnp.int32)
                      if n == "prec_phase"
                      else jnp.full(oshape, jnp.float32(MISSING)))
                  for n in RawForcing._fields}
        if active:
            nact = len(active)
            W = jax.lax.dynamic_slice_in_dim(fd["stf"], t0, tc, axis=0)
            A = jnp.take(W, fd["widx"], axis=2)      # [tc, n_act, b, SMAX]
            A = jnp.transpose(A, (2, 0, 1, 3)).reshape(
                n_tiles, tc * nact, smax)
            out = jax.lax.dot_general(
                A, fd["oh"], (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)  # [b, tc*na, tile_p]
            out = out.reshape(n_tiles, tc, nact, subl, ps.LANE)
            for i, n in enumerate(active):
                leaves[n] = (out[:, :, i].astype(jnp.int32)
                             if n == "prec_phase" else out[:, :, i])
        return RawForcing(**leaves)

    def fused_window(self, data, t0, tc: int):
        """[n_tiles, tc, NCH, subl, LANE] kernel-ready tile-major packed
        forcing: one dynamic time slice of the station stack, a tiny
        station-window row gather, and one batched one-hot matmul.  No
        [tc, NCH, P] point-major tensor is ever materialized and no
        transpose exists between here and the kernel's per-tile contiguous
        loads."""
        from .ops import pallas_step as ps
        plan = self._fused_plan
        fd = data["prep"]["fused"]
        smax, n_tiles, tile_p = plan["smax"], plan["n_tiles"], plan["tile_p"]
        W = jax.lax.dynamic_slice_in_dim(fd["stf"], t0, tc, axis=0)
        A = jnp.take(W, fd["widx"], axis=2)           # [tc, NCHS, b, SMAX]
        nchs = ps.NCH_SLIM
        A = jnp.transpose(A, (2, 0, 1, 3)).reshape(n_tiles, tc * nchs, smax)
        out = jax.lax.dot_general(
            A, fd["oh"], (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)      # [b, tc*NCHS, tile_p]
        return out.reshape(n_tiles, tc, nchs, tile_p // ps.LANE, ps.LANE)

    def host_at(self, sim_sel, names=("tair", "tdew", "rhz")) -> dict:
        """Host-side per-point values at selected sim steps [n] (for output
        writers and anchor derivation): {name: [P, n]}."""
        sel = np.asarray(sim_sel)
        out = {}
        for n in names:
            v = np.asarray(getattr(self._raw_host, n))[:, sel]
            out[n] = np.where(self._ok_host[:, None], v[self._ie_host],
                              -9999.9)
        return out

    @property
    def device_data(self):
        d = {"ch": self.channels, "ok": self.ok, "sidx": self.st_idx}
        if self.prep_data is not None:
            d["prep"] = self.prep_data
        if self._raw_tm is not None:
            d["tm"] = self._raw_tm
        return d

    def window(self, data, t0, tc: int) -> RawForcing:
        return self.window_from(data["ch"], data["ok"], data["sidx"], t0, tc)

    def packed_window(self, data, t0, tc: int, sw_cof, lw_cof, obs):
        """[tc, NCH, P] kernel-ready packed forcing from the station-level
        PREPARED channels: per chunk only the row gather + the per-point
        channels (radiation cofs, coupling obs) remain -- semantically
        identical to prepare_window + pack_forcing on the expanded raws
        (tests/test_production.py::test_production_fast_prep_matches)."""
        from .ops import pallas_step as ps
        pd = data["prep"]
        sidx = pd["sidx"]
        Pn = sidx.shape[0]

        def rows(ch):
            sl = jax.lax.dynamic_slice_in_dim(ch, t0, tc, axis=1)
            return jnp.take(sl, sidx, axis=0).T            # [tc, P]

        trf = jax.lax.dynamic_slice_in_dim(pd["trf"], t0, tc)
        out = [None] * ps.NCH
        for c, ch in pd["ch"].items():
            out[c] = rows(ch)
        out[ps.C_TRF] = jnp.broadcast_to(trf[:, None], (tc, Pn))
        out[ps.C_SWCOF] = jnp.asarray(sw_cof, jnp.float32)
        out[ps.C_LWCOF] = jnp.asarray(lw_cof, jnp.float32)
        out[ps.C_CPLOBS] = jnp.broadcast_to(
            jnp.asarray(obs, jnp.float32)[None, :], (tc, Pn))
        zero = jnp.zeros((tc, Pn), jnp.float32)
        return jnp.stack([c if c is not None else zero for c in out], axis=1)

    @staticmethod
    def window_from(channels: RawForcing, ok, st_idx, t0, tc: int
                    ) -> RawForcing:
        """[Tc, P] raw forcing for global steps [t0, t0+tc) from explicit
        arrays.  channels/ok/st_idx MUST be traced jit arguments, never
        closures -- closed-over arrays are baked into the HLO as constants,
        and at production station counts that overflows compile-request
        limits (hundreds of MB)."""
        def expand(ch, name):
            sl = jax.lax.dynamic_slice_in_dim(ch, t0, tc, axis=1)  # [S, Tc]
            v = jnp.take(sl, st_idx, axis=0)                       # [P, Tc]
            miss = -9999 if name == "prec_phase" else jnp.asarray(
                MISSING, v.dtype)
            return jnp.where(ok[:, None], v, miss).T               # [Tc, P]
        return RawForcing(*(expand(getattr(channels, n), n)
                            for n in RawForcing._fields))

    def raw_window(self, t0, tc: int) -> RawForcing:
        """[Tc, P] raw forcing for global steps [t0, t0+tc); called inside
        the chunk jit with traced t0."""
        return self.window_from(self.channels, self.ok, self.st_idx, t0, tc)


def merge_windows(windows: Sequence[RawForcing]) -> RawForcing:
    """Source-overlay merge of [Tc, P] windows in config order: later sources
    overwrite earlier values where valid (DataHandler per-value overlay,
    examples/example1/src/DataHandler.cpp:73-82 / DataManager.cpp:67-77)."""
    if len(windows) == 1:
        return windows[0]
    out = {}
    for name in RawForcing._fields:
        thr = valid_threshold(name)
        acc = getattr(windows[0], name)
        for w in windows[1:]:
            v = getattr(w, name)
            acc = jnp.where(v > thr, v, acc)
        out[name] = acc
    return RawForcing(**out)


class CompositeExpander:
    """Overlay of several expanders (grid + station sources in one config),
    merged per value in source order -- the example2 DataManager stack
    (examples/example2/src/DataManager.cpp:67-77) on device."""

    def __init__(self, parts: Sequence):
        assert parts
        self.parts = list(parts)
        self.num_points = parts[0].num_points
        self.t_pad = parts[0].t_pad
        self.dtype = parts[0].dtype
        # point permutation: either no part is permuted, or EVERY part
        # shares one permutation (the station part's station sort; grid
        # parts are built with point_perm=<that perm>) -- then the fused
        # tile-major raw overlay composes and the engine un-permutes outputs
        perms = [getattr(p, "point_perm", None) for p in parts]
        have = [q for q in perms if q is not None]
        if have and (len(have) != len(parts)
                     or any(not np.array_equal(q, have[0]) for q in have)):
            raise ValueError(
                "CompositeExpander parts must share one point permutation "
                "(build grid parts with point_perm=<station part's perm>) "
                "or none")
        self.point_perm = have[0] if have else None
        # when any part is permuted, ALL are (checked above) -- parts[0]'s
        # inverse is the shared one
        self.point_inv = parts[0].point_inv if have else None
        # fused tile-major overlay needs every part to emit raw tile-major
        # windows with one tile geometry
        geoms = [getattr(p, "tile_geom", None) for p in parts]
        self.tile_geom = (geoms[0] if all(
            g is not None and g == geoms[0] and hasattr(p, "window_tm")
            for g, p in zip(geoms, parts)) else None)
        for p in parts[1:]:
            assert p.num_points == self.num_points
            assert p.t_pad == self.t_pad, (p.t_pad, self.t_pad)
        self.first_host = {}
        for name in RawForcing._fields:
            thr = valid_threshold(name)
            acc = np.asarray(self.parts[0].first_host[name])
            for p in self.parts[1:]:
                v = np.asarray(p.first_host[name])
                acc = np.where(v > thr, v, acc)
            self.first_host[name] = acc

    @property
    def device_data(self):
        return tuple(p.device_data for p in self.parts)

    def window(self, data, t0, tc: int) -> RawForcing:
        return merge_windows([p.window(d, t0, tc)
                              for p, d in zip(self.parts, data)])

    def window_tm(self, data, t0, tc: int) -> RawForcing:
        """Tile-major raw overlay: each part expands in the kernel's tile
        layout, the per-value merge (elementwise) composes unchanged."""
        assert self.tile_geom is not None
        return merge_windows([p.window_tm(d, t0, tc)
                              for p, d in zip(self.parts, data)])

    def host_at(self, sim_sel, names=("tair", "tdew", "rhz")) -> dict:
        outs = [p.host_at(sim_sel, names) for p in self.parts]
        merged = {}
        for n in names:
            thr = valid_threshold(n)
            acc = outs[0][n]
            for o in outs[1:]:
                acc = np.where(o[n] > thr, o[n], acc)
            merged[n] = acc
        return merged


#: CheckValues input ranges (src/InputOutput.f90:55-82); a value outside its
#: range (or missing, -9999.9) poisons the point from that step on.
CHECK_RANGES = (("tair", -90.0, 100.0), ("tdew", -90.0, 100.0),
                ("rhz", -0.1, 120.0), ("vz", -1.0, 100.0),
                ("sw", -0.1, 4000.0), ("lw", -0.1, 1000.0),
                ("prec", -0.1, 500.0))


def validation_counts(expander, mesh, T: int, chunk_t: int = 64,
                      n_real: Optional[int] = None):
    """Per-variable CheckValues failure screen over the MERGED forcing.

    The reference reports per-variable missing required input up-front and
    skips those points (examples/example1/src/roadrunner.cpp:183-231).  With
    grid sources overlaying stations the up-front station-level check is
    skipped (the grid may fill the gaps), so this streams the merged
    on-device forcing chunk-by-chunk and counts, per variable, the points
    carrying any out-of-range/missing value (the final step is exempt --
    CheckValues does not run there, Simulation.f90:100-113).

    Returns ({var: point_count}, total_distinct_points).  Cost is one
    expansion pass (~prep-only rate); intended for verbose runs.
    """
    data = expander.device_data
    Pn = expander.num_points
    # the expander's tail padding covers windows up to t_pad; a larger
    # chunk would make dynamic_slice clamp its start and silently evaluate
    # the wrong time rows
    chunk_t = max(1, min(chunk_t, expander.t_pad - T))
    shp = NamedSharding(mesh, P(None, POINTS))

    @jax.jit
    def acc_chunk(bad, t0, data):
        raw = expander.window(data, t0, chunk_t)
        trow = t0 + jnp.arange(chunk_t)
        live = (trow < T - 1)[:, None]
        upd = []
        for name, lo, hi in CHECK_RANGES:
            v = getattr(raw, name)
            b = ((v < lo) | (v > hi)) & live
            upd.append(b.any(axis=0))
        return bad | jnp.stack(upd)

    bad = jax.device_put(np.zeros((len(CHECK_RANGES), Pn), bool), shp)
    for t0 in range(0, max(T - 1, 1), chunk_t):
        bad = acc_chunk(bad, np.int32(t0), data)
    badh = _to_host(bad)
    inv = getattr(expander, "point_inv", None)
    if inv is not None:
        badh = badh[:, inv]
    if n_real is not None:
        badh = badh[:, :n_real]
    counts = {name: int(c) for (name, _, _), c
              in zip(CHECK_RANGES, badh.sum(axis=1))}
    return counts, int(badh.any(axis=0).sum())


def last_valid_scan(expander, mesh, T: int, chunk_t: int = 64,
                    names=("tsurf_obs",), n_real: Optional[int] = None):
    """Per-point last-valid 0-based sim index + value of merged forcing
    channels, computed on device chunk-by-chunk.

    This recovers the two per-point scalars the reference driver derives by
    scanning the full obs series host-side -- the coupling observation
    (latest valid TSurfObs + its index, examples/example1/src/
    roadrunner.cpp:258-276 / examples/example2/src/QueryDataSource.cpp:905-977)
    and the relaxation anchor index (GetLatestObsIndex, JsonSource.cpp:397-414)
    -- without materializing the [P, T] series the grid expanders never build.

    Returns {name: (last_idx [P] int32 (-1 = none), value_at_last [P])}.
    """
    data = expander.device_data
    Pn = expander.num_points
    chunk_t = max(1, min(chunk_t, expander.t_pad - T))   # see validation_counts
    shp = NamedSharding(mesh, P(POINTS))

    @jax.jit
    def acc(carry, t0, data):
        raw = expander.window(data, t0, chunk_t)
        trow = (t0 + jnp.arange(chunk_t))[:, None]
        live = trow < T
        out = {}
        for n in names:
            idx, val = carry[n]
            v = jnp.asarray(getattr(raw, n), val.dtype)
            valid = (v > valid_threshold(n)) & live
            any_v = valid.any(axis=0)
            lastk = chunk_t - 1 - jnp.argmax(valid[::-1], axis=0)
            vlast = jnp.take_along_axis(v, lastk[None, :], axis=0)[0]
            out[n] = (jnp.where(any_v, t0 + lastk, idx).astype(jnp.int32),
                      jnp.where(any_v, vlast, val))
        return out

    carry = {n: (jax.device_put(np.full(Pn, -1, np.int32), shp),
                 jax.device_put(np.full(Pn, MISSING, np.float32), shp))
             for n in names}
    for t0 in range(0, T, chunk_t):
        carry = acc(carry, np.int32(t0), data)
    inv = getattr(expander, "point_inv", None)
    out = {}
    for n in names:
        idx, val = carry[n]
        idxh, valh = _to_host(idx), _to_host(val)
        if inv is not None:
            idxh, valh = idxh[inv], valh[inv]
        if n_real is not None:
            idxh, valh = idxh[:n_real], valh[:n_real]
        out[n] = (idxh, valh)
    return out


class GridExpander:
    """On-device gridded-NWP -> point forcing expansion (the QueryDataSource
    grid path, examples/example2/src/QueryDataSource.cpp:585-722, streamed).

    Host side (once): bilinear extraction of every grid field at the
    simulation points (QueryDataSource.cpp:931 ``InterpolatedValue``) onto the
    RAW forecast times -> compact [P, K] per-variable series, sharded over the
    points mesh axis (K = #raw times, typically ~75 hourly samples -- tiny
    next to [P, T]).

    Device side (per streaming chunk): the reference's gap-capped time
    interpolation with missing-sample search (QueryDataSource.cpp:331-425,
    io.gridsource.interpolate_gapped/nearest_gapped) evaluated for the
    chunk's sim steps.  The search runs over a static window of KW raw
    columns around the chunk's position -- KW is sized at build time so any
    sample pair within the 180-min gap cap lies inside the window; running
    last-valid/next-valid (time, value) pairs are computed by an unrolled
    forward/backward propagation over the KW rows (vectorized over P; no
    per-point gathers), and each
    chunk step picks its position's piecewise-linear segment by a uniform
    row gather.

    Semantics parity with ``GridSource.at_points`` + sim-grid sampling is
    enforced by tests/test_production_grid.py.
    """

    def __init__(self, times, glats, glons, fields: dict, plat, plon,
                 sim_epochs, mesh, chunk_t: int, dtype=jnp.float32,
                 max_gap_s: float = 180 * 60.0, tile_p: Optional[int] = None,
                 point_perm: Optional[np.ndarray] = None,
                 extract: str = "device"):
        assert extract in ("device", "host"), extract
        plat = np.asarray(plat, np.float64)
        plon = np.asarray(plon, np.float64)
        self.num_points = Pn = len(plat)
        self.mesh = mesh
        self.dtype = dtype
        # kernel tile-major device layout [n_tiles, K, subl, LANE] whenever
        # the point count tiles the mesh: the per-chunk time interpolation
        # then lands directly in the Pallas kernel's tile-major layout (the
        # fused-generic production path) with NO point-major transpose.
        self.tile_geom = tile_geometry(Pn, mesh, tile_p)
        # shared point permutation of a CompositeExpander whose station part
        # sorts points by station: device arrays live in SORTED order,
        # host-facing interfaces (first_host / host_at) stay in caller order
        self.point_perm = (np.asarray(point_perm)
                           if point_perm is not None else None)
        self.point_inv = None
        if self.point_perm is not None:
            inv = np.empty(Pn, np.int64)
            inv[self.point_perm] = np.arange(Pn)
            self.point_inv = inv
        self.max_gap_s = float(max_gap_s)
        sim = np.asarray(sim_epochs, np.int64)
        T = len(sim)
        self.sim_len = T
        self.t_pad = t_pad = (-(-T // chunk_t) + 1) * chunk_t

        times = np.asarray(times, np.int64)
        order = np.argsort(times, kind="stable")
        # keep-last at duplicate raw times (directory-merge convention)
        keep = np.ones(len(times), bool)
        keep[:-1] = np.diff(times[order]) > 0
        sel = order[keep]
        times = times[sel]
        fields = {k: np.asarray(v, np.float64)[sel] for k, v in fields.items()}
        K = len(times)
        if K == 0:
            raise ValueError("grid source has no time samples")

        # --- uniform (per-t) position machinery on the padded sim grid -----
        sim_pad = np.concatenate([sim, np.full(t_pad - T, sim[-1], np.int64)])
        pos = np.searchsorted(times, sim_pad, side="left")         # in [0, K]
        in_data = pos < K
        posc = np.clip(pos, 0, K - 1)
        texact = in_data & (times[posc] == sim_pad)
        # nearest-time pick for prec_phase (QueryDataSource.cpp:397-425):
        # candidates pos-1/pos, ties to the later sample, gap-capped
        p1 = np.clip(posc - 1, 0, K - 1)
        gap1 = (sim_pad - times[p1]).astype(np.float64)
        gap2 = (times[posc] - sim_pad).astype(np.float64)
        have_n = (pos > 0) & in_data & (np.minimum(gap1, gap2) <= max_gap_s)
        pick = np.where(gap1 < gap2, p1, posc).astype(np.int32)

        # --- static window geometry ---------------------------------------
        # MB raw columns below the position cover every j1 candidate within
        # the gap cap; MF columns above cover every j2 candidate (see the
        # have-mask analysis in window()); SPAN = max position advance
        # within any chunk_t-long stream window
        if K > 1:
            jmin = np.searchsorted(times, times[:-1] - int(max_gap_s),
                                   side="right")
            MB = int(np.max(np.arange(1, K) - jmin))
            jmax = np.searchsorted(times, times[1:] + int(max_gap_s),
                                   side="right") - 1
            MF = int(np.max(jmax - np.arange(1, K))) + 1
        else:
            MB, MF = 1, 1
        MB = max(MB, 1)
        span = int(np.max(pos[chunk_t - 1:] - pos[:t_pad - chunk_t + 1])) + 1
        self.MB = MB
        self.SPAN = span
        self.KW = min(K, MB + span + MF)
        self.K = K

        # --- host bilinear extraction + device placement ------------------
        rep = NamedSharding(mesh, P())
        shp2 = NamedSharding(mesh, P(POINTS, None))
        shp4 = NamedSharding(mesh, P(POINTS, None, None, None))
        fdt = np.float32 if dtype == jnp.float32 else np.float64
        self.var_names = [n for n in RawForcing._fields if n in fields]
        self._href = (times, glats, glons, fields, plat, plon, sim)
        self._pv_cache = {}        # name -> [P, R] float64 point series
        if (extract == "device" and self.var_names
                and len(np.atleast_1d(glats)) >= 2
                and len(np.atleast_1d(glons)) >= 2):
            pv_dev = self._extract_device(fields, glats, glons, plat, plon,
                                          fdt, shp2, shp4, rep)
        else:
            pv_dev = {}
            for name in self.var_names:
                pv = self._point_series(name)                      # [P, K]
                if self.point_perm is not None:
                    pv = pv[self.point_perm]
                if self.tile_geom is not None:
                    nt, subl = self.tile_geom
                    pv = pv.reshape(nt, subl, ps.LANE, K).transpose(
                        0, 3, 1, 2)
                    pv_dev[name] = jax.device_put(
                        np.ascontiguousarray(pv).astype(fdt), shp4)
                else:
                    pv_dev[name] = jax.device_put(
                        np.ascontiguousarray(pv).astype(fdt), shp2)
        # (the cache holds only _PV_STAPLES -- ~0.6 GB per variable at 1M
        # points; _point_series computes everything else without caching)
        self._data = {
            "pv": pv_dev,
            "trw": jax.device_put((times - sim[0]).astype(fdt), rep),
            "pos": jax.device_put(pos.astype(np.int32), rep),
            "trel": jax.device_put((sim_pad - sim[0]).astype(fdt), rep),
            "tex": jax.device_put(texact, rep),
            "pick": jax.device_put(pick, rep),
            "havep": jax.device_put(have_n, rep),
        }

        # first-step values: extract only the raw samples that can influence
        # sim[0] (within the gap cap) instead of the full series -- the full
        # [P, R] extraction is never needed when the device does the
        # spatial extraction
        from .io.gridsource import (bilinear_at_points,
                                    nearest_corner_at_points,
                                    timeseries_at_points)
        k1 = min(K, int(np.searchsorted(
            times, sim[0] + np.int64(max_gap_s), side="right")) + 1)
        pv1 = {}
        for n in self.var_names:
            sp = (nearest_corner_at_points if n == "prec_phase"
                  else bilinear_at_points)
            pv1[n] = sp(fields[n][:k1], glats, glons, plat, plon).T
        first = timeseries_at_points(times[:k1], pv1, sim[:1],
                                     self.max_gap_s)
        self.first_host = {
            n: (first[n][:, 0] if n in first
                else np.full(Pn, -9999 if n == "prec_phase" else MISSING))
            for n in RawForcing._fields}

    def _extract_device(self, fields, glats, glons, plat, plon, fdt,
                        shp2, shp4, rep) -> dict:
        """Device-side spatial extraction: ship the RAW [K, ny, nx] grids
        (tens of MB) plus per-point cell geometry instead of host-extracted
        [P, K] series (~2 GB at 1M points).  The bilinear cell indices / weights / tie-breaks are
        computed on host in float64 -- bit-identical geometry decisions to
        io.gridsource.bilinear_at_points / nearest_corner_at_points,
        including the sorted-corner first-valid-wins rule for prec_phase --
        so only the weighted accumulation runs in the device dtype.
        Matches examples/example2/src/QueryDataSource.cpp:931
        (InterpolatedValue: per point, on demand, from the raw grid)."""
        K = self.K
        Pn = self.num_points
        la = np.asarray(glats, np.float64)
        lo_ = np.asarray(glons, np.float64)
        flip = len(la) > 1 and la[1] < la[0]
        if flip:
            la = la[::-1]
        ny, nx = len(la), len(lo_)
        plat64 = np.asarray(plat, np.float64)
        plon64 = np.asarray(plon, np.float64)
        iy = np.clip(np.searchsorted(la, plat64, side="right") - 1, 0,
                     ny - 2)
        ix = np.clip(np.searchsorted(lo_, plon64, side="right") - 1, 0,
                     nx - 2)
        inside = ((plat64 >= la[0]) & (plat64 <= la[-1])
                  & (plon64 >= lo_[0]) & (plon64 <= lo_[-1]))
        dy = la[iy + 1] - la[iy]
        dx = lo_[ix + 1] - lo_[ix]
        fy = np.where(dy > 0, (plat64 - la[iy]) / np.where(dy > 0, dy, 1.0),
                      0.0)
        fx = np.where(dx > 0, (plon64 - lo_[ix]) / np.where(dx > 0, dx, 1.0),
                      0.0)
        i_list, w_list = [], []
        for cy, cx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                          (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            i_list.append((iy + cy) * nx + (ix + cx))
            w_list.append(w)
        idx4 = np.stack(i_list, axis=1).astype(np.int32)   # [P, 4]
        w4 = np.stack(w_list, axis=1)                      # [P, 4] float64
        # nearest-valid-corner pick order: weight-descending, stable in
        # corner order (the host loop's strict `w > best` tie-break)
        order = np.argsort(-w4, axis=1, kind="stable")
        sidx4 = np.take_along_axis(idx4, order, axis=1)
        if self.point_perm is not None:
            sel = self.point_perm
            idx4, w4, sidx4 = idx4[sel], w4[sel], sidx4[sel]
            inside = inside[sel]
        mesh = self.mesh
        shpP2 = NamedSharding(mesh, P(POINTS, None))
        shpP1 = NamedSharding(mesh, P(POINTS))
        idx4_d = jax.device_put(idx4, shpP2)
        sidx4_d = jax.device_put(sidx4, shpP2)
        w4_d = jax.device_put(np.ascontiguousarray(w4.astype(fdt)), shpP2)
        ins_d = jax.device_put(inside, shpP1)
        tiled = self.tile_geom is not None
        out_sh = shp4 if tiled else shp2

        def build(ff, idx4, w4, sidx4, inside, nearest):
            insr = inside[None, :]
            if nearest:
                best = jnp.full((K, Pn), MISSING, ff.dtype)
                havec = jnp.zeros((K, Pn), bool)
                for c in range(4):
                    v = jnp.take(ff, sidx4[:, c], axis=1)
                    valid = ~(jnp.isnan(v) | (v <= -9000.0))
                    upd = valid & ~havec
                    best = jnp.where(upd, v, best)
                    havec = havec | valid
                out = jnp.where(insr, best, jnp.asarray(MISSING, ff.dtype))
            else:
                acc = jnp.zeros((K, Pn), ff.dtype)
                wsum = jnp.zeros((K, Pn), ff.dtype)
                for c in range(4):
                    v = jnp.take(ff, idx4[:, c], axis=1)
                    valid = ~(jnp.isnan(v) | (v <= -9000.0))
                    w = w4[:, c][None, :]
                    acc = acc + jnp.where(valid, v, 0.0) * w
                    wsum = wsum + w * valid
                ok = (wsum > 1e-12) & insr
                out = jnp.where(ok, acc / jnp.where(wsum > 1e-12, wsum, 1.0),
                                jnp.asarray(MISSING, ff.dtype))
            if tiled:
                nt, subl = self.tile_geom
                return jnp.transpose(out.reshape(K, nt, subl, ps.LANE),
                                     (1, 0, 2, 3))
            return out.T

        # two compiled programs total (bilinear / nearest), shared across
        # variables -- a per-variable jit would recompile the identical
        # extraction once per field
        fns = {nearest: jax.jit(partial(build, nearest=nearest),
                                out_shardings=out_sh)
               for nearest in (False, True)}
        pv = {}
        for name in self.var_names:
            f = np.asarray(fields[name])
            if flip:
                f = f[:, ::-1, :]
            ff = jax.device_put(np.ascontiguousarray(
                f.reshape(K, ny * nx).astype(fdt)), rep)
            pv[name] = fns[name == "prec_phase"](ff, idx4_d, w4_d, sidx4_d,
                                                 ins_d)
            del ff
        return pv

    #: host_at variables worth keeping resident (repeated reads by the
    #: output writer and the relaxation derivation loops); everything else
    #: is a rare one-off and recomputes rather than pinning ~0.6 GB/var
    _PV_STAPLES = ("tair", "tdew", "rhz", "vz")

    def _point_series(self, name) -> np.ndarray:
        """Spatially-extracted [P, R] float64 series; staples are cached
        (the bilinear / nearest-corner pass is by far the heaviest part of
        host_at and identical on every call), non-staples recompute so the
        cache never regrows past the staple set."""
        if name in self._pv_cache:
            return self._pv_cache[name]
        from .io.gridsource import bilinear_at_points, \
            nearest_corner_at_points
        times, glats, glons, fields, plat, plon, _ = self._href
        interp_sp = (nearest_corner_at_points if name == "prec_phase"
                     else bilinear_at_points)
        out = interp_sp(fields[name], glats, glons, plat, plon).T  # [P, R]
        if name in self._PV_STAPLES:
            self._pv_cache[name] = out
        return out

    def _host_values(self, sim_abs, names) -> dict:
        """The GridSource.at_points pipeline at arbitrary epoch times
        (shared implementation: io.gridsource.timeseries_at_points over the
        cached per-point series); returns {name: [P, n]} for requested
        names, missing-filled for absent variables."""
        from .io.gridsource import timeseries_at_points
        times = self._href[0]
        Pn = self.num_points
        want = set(names) | ({"tair", "tdew", "rhz"} & set(self.var_names))
        sim_abs = np.asarray(sim_abs, np.int64)
        pv = {n: self._point_series(n)
              for n in sorted(want & set(self.var_names))}
        out = timeseries_at_points(times, pv, sim_abs, self.max_gap_s)
        for n in names:
            if n not in out:
                out[n] = np.full((Pn, len(sim_abs)),
                                 -9999 if n == "prec_phase" else MISSING)
        return out

    def host_at(self, sim_sel, names=("tair", "tdew", "rhz")) -> dict:
        """Host-side per-point values at selected sim steps (for output
        writers and anchor derivation): {name: [P, n]}."""
        _, _, _, _, _, _, sim = self._href
        sel = np.asarray(sim_sel)
        return self._host_values(sim[sel], tuple(names))

    @property
    def device_data(self):
        return self._data

    def window(self, data, t0, tc: int) -> RawForcing:
        """[tc, P] RawForcing for global sim steps [t0, t0+tc); runs inside
        the chunk jit (t0 traced)."""
        if self.tile_geom is None:
            return self._raw_window(data, t0, tc, tiled=False)
        out = self._raw_window(data, t0, tc, tiled=True)
        conv = lambda a: jnp.transpose(a, (1, 0, 2, 3)).reshape(
            tc, self.num_points)
        return RawForcing(*(conv(x) for x in out))

    def window_tm(self, data, t0, tc: int) -> RawForcing:
        """Tile-major RawForcing with [n_tiles, tc, subl, LANE] leaves: the
        interpolation computes directly in the kernel's point layout (flat
        point index = tile*tile_p + subl*LANE + lane = the natural order),
        so no transpose exists between here and the kernel DMA."""
        assert self.tile_geom is not None
        return self._raw_window(data, t0, tc, tiled=True)

    def _raw_window(self, data, t0, tc: int, tiled: bool) -> RawForcing:
        """The gap-capped time-interpolation pipeline, layout-generic:
        ``tiled=False`` works on [*, P] point-flat arrays (pv [P, K]),
        ``tiled=True`` on [n_tiles, *, subl, LANE] (pv [n_tiles, K, subl,
        LANE]); every per-point rule is elementwise, so both layouts execute
        the identical op sequence."""
        KW, MB, SPAN, K = self.KW, self.MB, self.SPAN, self.K
        Pn = self.num_points
        miss = jnp.asarray(MISSING, self.dtype)

        k0 = jax.lax.dynamic_slice(data["pos"], (t0,), (1,))[0]
        lo = jnp.clip(k0 - MB, 0, max(K - KW, 0))
        tw = jax.lax.dynamic_slice(data["trw"], (lo,), (KW,))      # [KW]
        pos_c = jax.lax.dynamic_slice(data["pos"], (t0,), (tc,))   # [tc]
        s_t = jnp.clip(pos_c - k0, 0, SPAN - 1)
        t_r = jax.lax.dynamic_slice(data["trel"], (t0,), (tc,))
        tr0 = t_r[0]
        z = jnp.zeros((), lo.dtype)
        if tiled:
            nt, subl = self.tile_geom
            pshape = (nt, subl, ps.LANE)
            grab = lambda a: jax.lax.dynamic_slice(
                a, (z, lo, z, z), (nt, KW, subl, ps.LANE))
            rowk = lambda a, k: a[:, k]                   # static raw row
            rowd = lambda a, i: jax.lax.dynamic_slice_in_dim(
                a, i, 1, 1)[:, 0]                         # traced raw row
            stk = lambda xs: jnp.stack(xs, axis=1)
            tvec = lambda x: x.reshape(1, tc, 1, 1)
            pexp = lambda x: x[:, None]       # point-shaped -> + tc axis
            oshape = (nt, tc, subl, ps.LANE)
        else:
            pshape = (Pn,)
            grab = lambda a: jax.lax.dynamic_slice(a, (z, lo), (Pn, KW)).T
            rowk = lambda a, k: a[k]
            rowd = lambda a, i: jax.lax.dynamic_slice_in_dim(a, i, 1, 0)[0]
            stk = lambda xs: jnp.stack(xs, axis=0)
            tvec = lambda x: x.reshape(tc, 1)
            pexp = lambda x: x[None, :]
            oshape = (tc, Pn)
        tex = tvec(jax.lax.dynamic_slice(data["tex"], (t0,), (tc,)))
        NEG, POS = jnp.asarray(-3e38, self.dtype), jnp.asarray(3e38,
                                                               self.dtype)

        def continuous(pvw, validw):
            # running last-valid / next-valid (time, value) pairs over the
            # KW window rows -- raw times increase, so propagation is a
            # plain where-carry (no comparisons), vectorized over P
            lv_t, lv_v = [], []
            ct = jnp.full(pshape, NEG)
            cv = jnp.zeros(pshape, self.dtype)
            for k in range(KW):
                ct = jnp.where(rowk(validw, k), tw[k], ct)
                cv = jnp.where(rowk(validw, k), rowk(pvw, k), cv)
                lv_t.append(ct)
                lv_v.append(cv)
            nx_t, nx_v = [None] * KW, [None] * KW
            ct = jnp.full(pshape, POS)
            cv = jnp.zeros(pshape, self.dtype)
            for k in reversed(range(KW)):
                ct = jnp.where(rowk(validw, k), tw[k], ct)
                cv = jnp.where(rowk(validw, k), rowk(pvw, k), cv)
                nx_t[k] = ct
                nx_v[k] = cv
            lv_t, lv_v = stk(lv_t), stk(lv_v)
            nx_t, nx_v = stk(nx_t), stk(nx_v)

            # per-step segment pick as a SPAN-way broadcast select sweep
            # (instead of a [tc]-indexed jnp.take over the stacked
            # segments): the where-chain fuses into one elementwise pass
            # over the [*, tc, *] output
            trel = tvec(t_r - tr0)
            res = None
            ex_v, ex_ok = None, None
            for s in range(SPAN):
                kg = k0 + s                       # global position index
                kl = jnp.clip(kg - lo, 0, KW - 1)
                klm1 = jnp.clip(kg - lo - 1, 0, KW - 1)
                t1, v1 = rowd(lv_t, klm1), rowd(lv_v, klm1)
                t2, v2 = rowd(nx_t, kl), rowd(nx_v, kl)
                gap = t2 - t1
                have = ((kg > 0) & (kg < K) & (t1 > NEG * 0.5)
                        & (t2 < POS * 0.5) & (gap <= self.max_gap_s))
                invg = jnp.where(gap > 0, 1.0 / gap, 0.0)
                beta = jnp.where(have, (v2 - v1) * invg, 0.0)
                # chunk-rebased intercept: v(t) = alpha + (t - tr0) * beta
                # keeps the f32 cancellation at window scale, not run scale
                alpha = jnp.where(have, v1 + (tr0 - t1) * beta, miss)
                seg = pexp(alpha) + trel * pexp(beta)
                e_s = pexp(rowd(pvw, kl))
                eo_s = pexp(rowd(validw, kl) & (kg < K))
                if res is None:                   # s_t == 0 covers seg 0
                    res, ex_v, ex_ok = seg, e_s, eo_s
                else:
                    on = tvec(s_t == s)
                    res = jnp.where(on, seg, res)
                    ex_v = jnp.where(on, e_s, ex_v)
                    ex_ok = jnp.where(on, eo_s, ex_ok)
            # exact-time valid samples override unconditionally
            # (QueryDataSource.cpp:798-801 / interpolate_gapped)
            return jnp.where(tex & ex_ok, ex_v, res)

        out = {}
        for name in RawForcing._fields:
            arr = data["pv"].get(name)
            if arr is None:
                out[name] = (jnp.full(oshape, -9999, jnp.int32)
                             if name == "prec_phase"
                             else jnp.full(oshape, miss))
                continue
            pvw = grab(arr)              # raw-time axis at the stack slot
            validw = pvw > -9000.0
            if name == "prec_phase":
                pickw = jax.lax.dynamic_slice(data["pick"], (t0,), (tc,))
                havep = tvec(jax.lax.dynamic_slice(data["havep"], (t0,),
                                                   (tc,)))
                lpick = tvec(jnp.clip(pickw - lo, 0, KW - 1))
                lpos = tvec(jnp.clip(pos_c - lo, 0, KW - 1))
                # KW-way select sweep (see the continuous() note)
                vnear = vex = vexok = None
                for k in range(KW):
                    pk, vk = pexp(rowk(pvw, k)), pexp(rowk(validw, k))
                    if vnear is None:
                        vnear, vex, vexok = pk, pk, vk
                    else:
                        vnear = jnp.where(lpick == k, pk, vnear)
                        vex = jnp.where(lpos == k, pk, vex)
                        vexok = jnp.where(lpos == k, vk, vexok)
                res = jnp.where(tex & vexok, vex,
                                jnp.where(havep, vnear, miss))
                out[name] = jnp.where(res > -9000.0, res,
                                      -9999.0).astype(jnp.int32)
                continue
            res = continuous(pvw, validw)
            if name == "rhz":
                res = jnp.where(res > -9000.0, jnp.clip(res, 0.0, 100.0),
                                res)
            if name == "prec":
                res = jnp.where(res > 100.0, miss, res)
            out[name] = res

        # Tdew <-> RH completion per source (QueryDataSource.cpp:817-828)
        ta, td, rh = out["tair"], out["tdew"], out["rhz"]
        t_ok = ta > -9000.0
        if "tair" in self.var_names:
            from .physics.moisture import rh_from_tdew, tdew_from_rh
            need_td = (td <= -9000.0) & (rh > -9000.0) & t_ok
            need_rh = (rh <= -9000.0) & (td > -9000.0) & t_ok
            out["tdew"] = jnp.where(need_td, tdew_from_rh(ta, rh), td)
            out["rhz"] = jnp.where(need_rh, rh_from_tdew(ta, td), rh)
        return RawForcing(**out)


class ProductionResult(NamedTuple):
    state: State                 #: final prognostic state (unpadded)
    out_steps: np.ndarray        #: [n_out] global 0-based step indices
    fields: dict                 #: name -> [n_out, P_local] numpy
    point_steps_per_s: float     #: sustained streaming rate (real points)
    #: global [lo, hi) point range this result covers: the full run under
    #: drain="gather", this process's shard under drain="shard"
    point_range: tuple = (0, -1)


class _Engine:
    """Device placement + chunk-fn compilation + range streaming shared by
    the uncoupled and coupled production drivers."""

    def __init__(self, model: Model, expander, pts: PointParams,
                 cal: Calendar, state: State, *, anchors=None, mesh=None,
                 chunk_t: int = 64, out_stride: Optional[int] = None,
                 bl_iters: int = 40, metrics: Optional[RunMetrics] = None,
                 drain: str = "gather"):
        assert drain in ("gather", "shard"), drain
        self.drain_mode = drain
        settings, params, cfg, grid = (model.settings, model.params,
                                       model.cfg, model.grid)
        self.model = model
        self.expander = expander
        self.settings, self.params, self.cfg, self.grid = (settings, params,
                                                           cfg, grid)
        self.T = settings.sim_len
        self.mesh = mesh or make_mesh()
        self.interpret = kernel_interpret(self.mesh)
        self.os_ = int(out_stride or settings.output_stride)
        self.metrics = metrics or RunMetrics()
        self.chunk_t = chunk_t
        self.bl_iters = bl_iters

        if cfg.use_depth is False and np.any(np.asarray(pts.out_depth) >= 0.0):
            raise ValueError(
                "per-point out_depth is not supported by the fused kernel; "
                "use the scan engine (runner --engine scan) or set the "
                "global model.tsurfOutputDepth")

        mesh_ = self.mesh
        self.n_real = int(np.asarray(pts.lat).shape[0])
        self.P_pad = padded_points(self.n_real, mesh_)
        assert expander.num_points == self.P_pad, (
            f"expander built for {expander.num_points} points, need "
            f"{self.P_pad}")
        # a point-permuted expander (fused one-hot expansion) keeps its device
        # arrays in station-sorted order; every per-point array the engine
        # places must follow, and outputs are un-permuted in assemble()
        self._perm = getattr(expander, "point_perm", None)
        self._inv = getattr(expander, "point_inv", None)

        with self.metrics.phase("setup"):
            dtype = expander.dtype
            self.dtype = dtype
            skyview_active = ((np.asarray(pts.sky_view) < 1.0)
                              & (np.asarray(pts.sky_view) > -0.01))
            self.enable_sky = bool(skyview_active.any())

            shp = NamedSharding(mesh_, P(POINTS))
            sh2 = NamedSharding(mesh_, P(POINTS, None))
            rep = NamedSharding(mesh_, P())

            def put_pts(x, spec, dt=None):
                x = _pad_tail(np.asarray(x), self.P_pad, axis=0)
                if self._perm is not None:
                    x = x[self._perm]
                if dt is not None:
                    x = x.astype(dt)
                return jax.device_put(x, spec)

            fdt = np.float32 if dtype == jnp.float32 else np.float64
            hor_np = np.asarray(pts.horizons)
            # statically-known flat horizons let the sky-view prep skip the
            # per-(point, step) horizon lookup entirely
            self.flat_horizons = not hor_np.any()
            if self.enable_sky and hor_np.any():
                horizons_dev = put_pts(hor_np, sh2, fdt)
            else:
                # flat horizons (sky-view factor only, the common case):
                # the prep's flat_horizons static path never reads the
                # table, so a 1-wide zero placeholder suffices -- a real
                # [P, 360] tensor is 1.5 GB of device memory at 1M points
                p_pad_ = self.P_pad
                horizons_dev = jax.jit(
                    lambda: jnp.zeros((p_pad_, 1), fdt),
                    out_shardings=sh2)()
            self.pts_dev = PointParams(
                lat=put_pts(pts.lat, shp, fdt),
                lon=put_pts(pts.lon, shp, fdt),
                sky_view=put_pts(pts.sky_view, shp, fdt),
                horizons=horizons_dev,
                init_len=put_pts(pts.init_len, shp, np.int32),
                tair_relax=put_pts(pts.tair_relax, shp, fdt),
                vz_relax=put_pts(pts.vz_relax, shp, fdt),
                rh_relax=put_pts(pts.rh_relax, shp, fdt),
                coupling_start=put_pts(pts.coupling_start, shp, np.int32),
                coupling_end=put_pts(pts.coupling_end, shp, np.int32),
                coupling_tsurf=put_pts(pts.coupling_tsurf, shp, fdt),
                out_depth=put_pts(pts.out_depth, shp, fdt))
            self.obs_dev = self.pts_dev.coupling_tsurf

            self.anchors_dev = None
            if settings.use_relaxation:
                # anchor series values (X_initEnd, src/Relaxation.f90:10-47)
                # are per-point scalars gathered host-side once
                if anchors is None:
                    raise ValueError(
                        "settings.use_relaxation requires anchors; pass "
                        "anchors=forcing.relax_anchors(...)")
                self.anchors_dev = tuple(
                    put_pts(np.asarray(a, fdt), shp) for a in anchors)

            t_pad = expander.t_pad
            self.hour_dev = jax.device_put(
                _pad_tail(np.asarray(cal.hour, np.int32), t_pad), rep)
            self.jde_dev = None
            if self.enable_sky:
                self.jde_dev = jax.device_put(
                    _pad_tail(np.asarray(cal.jde, fdt), t_pad), rep)

            # packed state; padded points marked failed -> frozen at step 0.
            # Padding + packing run ON DEVICE (jit with sharded outputs): no
            # host round trip of the [P]-sized state
            n_real, p_pad = self.n_real, self.P_pad

            perm_loc_dev = None
            if self._perm is not None:
                # block-local permutation indices: the sort never crosses a
                # device block, so the state permute is a shard_map-local
                # gather (no cross-device collective)
                ndev = int(np.prod(mesh_.devices.shape))
                p_loc = p_pad // ndev
                perm_loc = (self._perm.reshape(ndev, p_loc)
                            - (np.arange(ndev) * p_loc)[:, None])
                assert (perm_loc >= 0).all() and (perm_loc < p_loc).all()
                perm_loc_dev = jax.device_put(
                    perm_loc.reshape(-1).astype(np.int32), shp)

            @partial(jax.jit, out_shardings=(sh_cols(mesh_), sh_cols(mesh_)))
            def _pad_pack(st, perm_loc):
                def padleaf(x):
                    x = jnp.asarray(x)
                    w = [(0, p_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
                    return jnp.pad(x, w, mode="edge")
                tmp, scal = ps.pack_state(jax.tree.map(padleaf, st))
                scal = scal.at[ps.R_FAILED, n_real:].set(1.0)
                if perm_loc is not None:
                    def loc(t, s, pl_):
                        return (jnp.take(t, pl_, axis=1),
                                jnp.take(s, pl_, axis=1))
                    tmp, scal = jax.shard_map(
                        loc, mesh=mesh_,
                        in_specs=(P(None, POINTS), P(None, POINTS),
                                  P(POINTS)),
                        out_specs=(P(None, POINTS), P(None, POINTS)))(
                            tmp, scal, perm_loc)
                return tmp, scal

            self.tmp0, self.scal0 = _pad_pack(state, perm_loc_dev)
            # unpack template for phase transitions (coupled driver): only
            # the pytree structure and dtypes matter (unpack_state replaces
            # every leaf), so keep it scalar -- a full-size template would be
            # baked into the phase-B HLO as constants
            self.template = jax.tree.map(
                lambda x: jnp.zeros((), jnp.asarray(x).dtype), state)

        self.fn_cache = {}
        # station-level prepared channels bypass per-point forcing prep
        # entirely; per-point sky-view correction cannot ride them
        self.fast = (not self.enable_sky
                     and getattr(expander, "prep_data", None) is not None)
        # fused one-hot expansion (tile-major kernel forcing): needs the
        # expander's sorted-point plan AND matching tile geometry
        self.fused = (self.fast and self._perm is not None
                      and "fused" in expander.prep_data)
        # fused-generic: any expander that can emit tile-major RAW windows
        # (GridExpander / CompositeExpander / raw-tm StationExpander) rides
        # the slim kernel layout, with the per-point forcing prep computed
        # tile-major inside the chunk jit (forcing.prepare_window
        # time_axis=1) -- the operational grid(+station) path's analogue of
        # the station fused path: no [tc, NCH, P] point-major tensor or
        # transpose exists anywhere
        tg = getattr(expander, "tile_geom", None)
        self.fused_generic = (not self.fused and not self.fast
                              and hasattr(expander, "window_tm")
                              and tg is not None)
        if self.fast:
            self._check_fast_contract(expander, pts)
            self.metrics.note(
                "station-level prepared channels active "
                + ("(fused one-hot expansion)" if self.fused
                   else "(fast forcing prep, row-gather expansion)"))
        elif self.fused_generic:
            self.metrics.note(
                "fused tile-major forcing path (per-point prep in the "
                "kernel's slim layout"
                + (", incl. sky view)" if self.enable_sky else ")"))
        elif self.enable_sky:
            self.metrics.note(
                "sky-view correction is per-point: generic per-point "
                "forcing prep (station fast path disabled; see docs/"
                "MANUAL.md engine/feature matrix)")
        elif isinstance(expander, StationExpander):
            self.metrics.note(
                "station expander built without prep_ctx: generic "
                "per-point forcing prep")
        # fixed output-row allocation: the max stride hits any chunk can
        # contain (keeps the jit variant count small: main + ragged chunks)
        self.k_alloc = (chunk_t - 1) // self.os_ + 1

        self.pts_tm = None
        self.anchors_tm = None
        self.trf_dev = None
        if self.fused_generic:
            # per-point params / anchors reshaped to the kernel tile layout
            # [n_tiles, subl, LANE] (tiny; horizons stay flat -- sky view is
            # off on this path) and the time-only traffic-friction channel
            # (SetDayDependendVariables, src/BalanceModel.f90:354-387)
            nt_g, subl_g = expander.tile_geom
            sh3 = NamedSharding(self.mesh, P(POINTS, None, None))
            rep_ = NamedSharding(self.mesh, P())
            tm_shape = (nt_g, subl_g, ps.LANE)

            def _tm(x):
                return jax.jit(lambda v: jnp.reshape(v, tm_shape),
                               out_shardings=sh3)(x)

            self.pts_tm = self.pts_dev._replace(
                **{n: _tm(getattr(self.pts_dev, n))
                   for n in PointParams._fields if n != "horizons"})
            if self.enable_sky and not self.flat_horizons:
                # horizon tables in tile layout, 360-axis LAST (flat
                # horizons never read the table -- keep the placeholder)
                hor = self.pts_dev.horizons
                H = hor.shape[1]
                sh4_ = NamedSharding(self.mesh,
                                     P(POINTS, None, None, None))
                self.pts_tm = self.pts_tm._replace(
                    horizons=jax.jit(
                        lambda v: jnp.reshape(v, tm_shape + (H,)),
                        out_shardings=sh4_)(hor))
            if self.anchors_dev is not None:
                self.anchors_tm = tuple(_tm(a) for a in self.anchors_dev)
            prm = self.params
            non, noff = float(prm.night_on), float(prm.night_off)
            tfd, tfn = float(prm.trf_fric_day), float(prm.trf_fric_ngt)

            def _trf(hour):
                night = (hour >= non) | (hour <= noff)
                return jnp.where(night, tfn, tfd).astype(jnp.float32)

            self.trf_dev = jax.jit(_trf, out_shardings=rep_)(self.hour_dev)

        # every device array the chunk fns consume travels as an EXPLICIT jit
        # argument: closed-over jax.Arrays are lowered as HLO constants, and
        # the station channels alone reach hundreds of MB at production scale
        # -- overflowing compile-request limits (and bloating every cache key)
        self.data = {
            "exp": expander.device_data, "hour": self.hour_dev,
            "jde": self.jde_dev, "pts": self.pts_dev,
            "anchors": self.anchors_dev, "obs": self.obs_dev,
            "pts_tm": self.pts_tm, "anchors_tm": self.anchors_tm,
            "trf": self.trf_dev,
        }
        self.data_shapes = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                           sharding=x.sharding), self.data)

    def _check_fast_contract(self, expander, pts):
        """The station-level fast path is only valid when every per-point
        prep parameter equals its station's (param i == st_pts[st_idx[i]],
        virtual row S for out-of-radius points).  The runner builds this by
        construction; a library caller passing a prep_ctx expander with
        mismatched per-point params would get silently wrong physics --
        so spot-check the gathered params here and fail loudly."""
        st_pts = getattr(expander, "_prep_st_pts", None)
        if st_pts is None:
            return
        S = np.asarray(expander._raw_host.tair).shape[0]
        ok = np.asarray(expander._ok_host)[:self.n_real]
        sidx = np.where(ok, np.asarray(expander._ie_host)[:self.n_real], S)
        gat = lambda n: np.asarray(getattr(st_pts, n), np.float64)[sidx]
        got = lambda n: np.asarray(getattr(pts, n), np.float64)

        def fail(name, mask):
            bad = int(np.argmax(mask))
            raise ValueError(
                f"station-level fast path contract violated at point {bad} "
                f"({name}: per-point {got(name)[bad]!r} vs st_pts"
                f"[{sidx[bad]}] {gat(name)[bad]!r}); the prep_ctx expander "
                f"requires param i == st_pts[st_idx[i]] for every "
                f"prep-relevant field (build pts by gathering st_pts, or "
                f"drop prep_ctx to use the generic path)")

        if not np.array_equal(gat("init_len"), got("init_len")):
            fail("init_len", gat("init_len") != got("init_len"))
        # relaxation validity is joint over the three fields
        # (forcing.prepare_window relax_valid); where OFF on both sides the
        # raw sentinels may differ
        def relax_on(t, v, r):
            return ((t >= -100.0) & (t <= 100.0) & (v >= 0.0) & (v <= 100.0)
                    & (r >= 0.0) & (r <= 110.0))
        names = ("tair_relax", "vz_relax", "rh_relax")
        on_w = relax_on(*(gat(n) for n in names))
        on_g = relax_on(*(got(n) for n in names))
        if not np.array_equal(on_w, on_g):
            fail("relax validity", on_w != on_g)
        for n in names:
            bad = on_w & (gat(n).astype(got(n).dtype) != got(n))
            if bad.any():
                fail(n, bad)
        # coupling activity (production coupled driver + prepare_window)
        def cpl_on(end, obs):
            return (end >= 1) & (obs > -100.0)
        cw = cpl_on(gat("coupling_end"), gat("coupling_tsurf"))
        cg = cpl_on(got("coupling_end"), got("coupling_tsurf"))
        if not np.array_equal(cw, cg):
            fail("coupling activity", cw != cg)
        for n in ("coupling_start", "coupling_end", "coupling_tsurf"):
            bad = cw & (gat(n).astype(got(n).dtype) != got(n))
            if bad.any():
                fail(n, bad)

    # -- chunk functions ----------------------------------------------------

    def slim_forcing(self, t0, data):
        """[n_tiles, tc, NCH_SLIM, subl, LANE] slim kernel forcing + its
        SMEM trf channel, from either fused path (traced; called inside the
        chunk jits and the bench tools)."""
        expander, chunk_t, T = self.expander, self.chunk_t, self.T
        if self.fused:
            return (expander.fused_window(data["exp"], t0, chunk_t),
                    data["exp"]["prep"]["trf"])
        # fused-generic: tile-major raw window -> per-point prep in
        # the kernel layout (no point-major tensor or transpose);
        # sky-view/horizon correction rides the same layout (elementwise
        # sun position + 360-way horizon select sweep)
        rawTM = expander.window_tm(data["exp"], t0, chunk_t)
        hr = jax.lax.dynamic_slice_in_dim(data["hour"], t0, chunk_t)
        jd = (jax.lax.dynamic_slice_in_dim(data["jde"], t0, chunk_t)
              if self.enable_sky else None)
        prep = prepare_window(
            rawTM, data["pts_tm"], hr, self.settings, self.params,
            t_offset=t0, t_total=T, anchors=data["anchors_tm"], jde=jd,
            enable_skyview=self.enable_sky,
            flat_horizons=self.flat_horizons, time_axis=1)
        f32 = lambda x: jnp.asarray(x, jnp.float32)
        tair, rhz = f32(prep.tair), f32(prep.rhz)
        eair, airvcap = ps.forcing_thermo(tair, rhz)
        ch = {ps.C_TAIR: tair, ps.C_VZ: f32(prep.vz),
              ps.C_EAIR: eair, ps.C_AIRVCAP: airvcap,
              ps.C_RAIN: f32(prep.rain), ps.C_SNOW: f32(prep.snow),
              ps.C_SW: f32(prep.sw), ps.C_LW: f32(prep.lw),
              ps.C_TSURF_OBS: f32(prep.tsurf_obs),
              ps.C_VALID: f32(prep.valid),
              ps.C_INCPL: f32(prep.in_coupling)}
        forc = jnp.stack([ch[c] for c in ps.SLIM_CHANNELS], axis=2)
        return forc, data["trf"]

    def chunk_fn(self, nsteps: int, with_cofs: bool):
        """One fused jit per (chunk length, cof mode): expand ->
        prepare_window -> pack -> sharded whole-scan kernel; the kernel
        writes exactly the run-level output-stride rows (traced global
        offset), so each chunk is ONE device dispatch."""
        key = (nsteps, with_cofs)
        if key in self.fn_cache:
            return self.fn_cache[key]
        settings, params, cfg, grid = (self.settings, self.params, self.cfg,
                                       self.grid)
        chunk_t, T = self.chunk_t, self.T
        mesh, enable_sky = self.mesh, self.enable_sky

        expander = self.expander

        def prep_chunk(t0, data):
            rawT = expander.window(data["exp"], t0, chunk_t)
            hr = jax.lax.dynamic_slice_in_dim(data["hour"], t0, chunk_t)
            jd = (jax.lax.dynamic_slice_in_dim(data["jde"], t0, chunk_t)
                  if enable_sky else None)
            return prepare_window(
                rawT, data["pts"], hr, settings, params, t_offset=t0,
                t_total=T, anchors=data["anchors"], jde=jd,
                enable_skyview=enable_sky,
                flat_horizons=self.flat_horizons)

        def launch(tmp, scal, forc, t0, nsteps,
                   slim_trf=None, aux_rows=None, aux_cofs=False):
            spec = (P(POINTS, None, None, None, None) if forc.ndim == 5
                    else P(None, None, POINTS))
            forc = jax.lax.with_sharding_constraint(
                forc, NamedSharding(mesh, spec))
            return pallas_scan_sharded(
                tmp, scal, forc, cfg, params, grid, mesh,
                out_stride=self.os_, bl_iters=self.bl_iters,
                interpret=self.interpret, nsteps=nsteps,
                out_offset=t0, n_out=self.k_alloc,
                slim_trf=slim_trf, aux_rows=aux_rows, aux_cofs=aux_cofs,
                t_total=(T if aux_cofs else None),
                cof_red=(settings.coupling_effect_reduction
                         if aux_cofs else None))

        fast = self.fast
        fused = self.fused
        fusedg = self.fused_generic
        slim_forcing = self.slim_forcing

        if with_cofs:

            @jax.jit
            def fn(tmp, scal, t0, data, sw_corr, lw_corr):
                if fused or fusedg:
                    # decayed coefficients computed IN KERNEL from the
                    # per-point aux rows (forcing.cof_window semantics);
                    # the slim tile-major forcing carries neither cof nor
                    # obs channels
                    forc, trf = slim_forcing(t0, data)
                    f32 = lambda x: jnp.asarray(x, jnp.float32)
                    aux = jnp.stack([
                        f32(sw_corr), f32(lw_corr),
                        f32(data["pts"].coupling_end), f32(data["obs"])])
                    return launch(tmp, scal, forc, t0, nsteps,
                                  slim_trf=trf, aux_rows=aux, aux_cofs=True)
                swc, lwc = cof_window(
                    sw_corr, lw_corr, data["pts"].coupling_end, t0, chunk_t,
                    T, settings, jnp.float32)
                if fast:
                    forc = expander.packed_window(data["exp"], t0, chunk_t,
                                                  swc, lwc, data["obs"])
                else:
                    prep = prep_chunk(t0, data)
                    forc = ps.pack_forcing(prep, swc, lwc, data["obs"])
                return launch(tmp, scal, forc, t0, nsteps)
        else:

            @jax.jit
            def fn(tmp, scal, t0, data):
                if fused or fusedg:
                    forc, trf = slim_forcing(t0, data)
                    f32 = lambda x: jnp.asarray(x, jnp.float32)
                    zero = jnp.zeros_like(f32(data["obs"]))
                    aux = jnp.stack([zero, zero, zero, f32(data["obs"])])
                    return launch(tmp, scal, forc, t0, nsteps,
                                  slim_trf=trf, aux_rows=aux)
                elif fast:
                    shape = (chunk_t, expander.num_points)
                    ones = jnp.ones(shape, jnp.float32)
                    forc = expander.packed_window(data["exp"], t0, chunk_t,
                                                  ones, ones, data["obs"])
                else:
                    prep = prep_chunk(t0, data)
                    ones = jnp.ones(prep.tair.shape, jnp.float32)
                    forc = ps.pack_forcing(prep, ones, ones, data["obs"])
                return launch(tmp, scal, forc, t0, nsteps)

        self.fn_cache[key] = fn
        return fn

    def _chunk_grid(self, t_lo: int, t_hi: int):
        n = t_hi - t_lo
        if n <= 0:
            return []
        nchunks = -(-n // self.chunk_t)
        return [(t_lo + k * self.chunk_t,
                 min(self.chunk_t, t_hi - t_lo - k * self.chunk_t))
                for k in range(nchunks)]

    def compile_range(self, t_lo: int, t_hi: int, with_cofs: bool):
        """AOT-compile every chunk variant of a stream range."""
        shapes = [jax.ShapeDtypeStruct(self.tmp0.shape, self.tmp0.dtype,
                                       sharding=self.tmp0.sharding),
                  jax.ShapeDtypeStruct(self.scal0.shape, self.scal0.dtype,
                                       sharding=self.scal0.sharding),
                  jax.ShapeDtypeStruct((), jnp.int32), self.data_shapes]
        if with_cofs:
            corr = jax.ShapeDtypeStruct(
                (self.P_pad,), jnp.float32,
                sharding=NamedSharding(self.mesh, P(POINTS)))
            shapes += [corr, corr]
        for ns in sorted({ns for _, ns in self._chunk_grid(t_lo, t_hi)}):
            self.chunk_fn(ns, with_cofs).lower(*shapes).compile()

    def stream(self, tmp, scal, t_lo: int, t_hi: int, cofs=None,
               progress: Optional[Progress] = None, collected=None):
        """Stream global forcing rows [t_lo, t_hi) through the kernel with
        two-deep pipelined dispatch.  ``cofs``: optional (sw_corr, lw_corr)
        device arrays enabling the decayed-coefficient channels.  Returns
        (tmp, scal, collected) with collected = [(steps, [k, 6, P] np)]."""
        collected = collected if collected is not None else []
        pending = []

        def drain(item):
            steps, probe = item
            if steps:
                collected.append((steps, self._pull(probe)[:len(steps)]))
            else:
                probe.block_until_ready()   # backpressure without output rows
            if progress:
                progress.update(self.chunk_t)

        for t0, nsteps_c in self._chunk_grid(t_lo, t_hi):
            first_hit = -(-t0 // self.os_) * self.os_
            steps = list(range(first_hit, t0 + nsteps_c, self.os_))
            fn = self.chunk_fn(nsteps_c, cofs is not None)
            args = (tmp, scal, np.int32(t0), self.data) \
                + (tuple(cofs) if cofs else ())
            tmp, scal, rows = fn(*args)
            pending.append((steps, rows if steps else scal))
            if len(pending) > 1:
                drain(pending.pop(0))
        for item in pending:
            drain(item)
        return tmp, scal, collected

    def _pull(self, rows) -> np.ndarray:
        """Output rows [k, F, P] -> host per the drain mode: ``gather``
        allgathers the full points axis (single host / tests); ``shard``
        pulls ONLY this process's addressable columns (no cross-host
        gather -- the operational multi-host path)."""
        if self.drain_mode == "shard":
            loc, rng = host_shard(rows, axis=-1)
            assert self._shard_rng in (None, rng), (self._shard_rng, rng)
            self._shard_rng = rng
            return loc
        return _to_host(rows)

    _shard_rng = None

    def assemble(self, collected, tmp, scal, wall: float) -> ProductionResult:
        shard = self.drain_mode == "shard"
        with self.metrics.phase("output"):
            rate = self.n_real * self.T / wall
            self.metrics.count("point_steps_per_s", round(rate, 1))
            self.metrics.count("points", self.n_real)
            self.metrics.count("steps", self.T)

            # unpack ON DEVICE, then one host pull per leaf: pulling the
            # packed rows to host and unpacking there bounces the state
            # host->device->host again (jnp ops re-upload)
            unpack = jax.jit(lambda t, s: ps.unpack_state(
                t, s, self.grid.nlayers, self.template))
            ust = unpack(tmp, scal)
            if shard:
                rngs = []

                def pull(x):
                    loc, rng = host_shard(x, axis=0)
                    rngs.append(rng)
                    return loc
                hleaves = jax.tree.map(pull, ust)
                lo, hi = rngs[0]
                assert all(r == (lo, hi) for r in rngs), rngs
                assert self._shard_rng in (None, (lo, hi))
            else:
                hleaves = jax.tree.map(_to_host, ust)
                lo, hi = 0, self.P_pad
            # a padding-only shard (every row >= n_real) must anchor its
            # empty range at n_real so the shard ranges still tile
            # [0, n_real) exactly for merge_shards
            lo_eff = min(lo, self.n_real)
            n_loc = max(0, min(hi, self.n_real) - lo)
            if self._inv is not None:      # sorted -> original point order
                inv = self._inv[lo:hi] - lo   # block-local, stays in range
                sel = inv[:n_loc]
            else:
                inv = None
                sel = slice(None, n_loc)
            final = jax.tree.map(lambda x: jnp.asarray(x[sel]), hleaves)

            all_steps = np.concatenate(
                [np.asarray(s, np.int64) for s, _ in collected]) \
                if collected else np.zeros(0, np.int64)
            stacked = (np.concatenate([a for _, a in collected], axis=0)
                       if collected else
                       np.zeros((0, 6, hi - lo), np.float32))
            order = np.argsort(all_steps)
            all_steps = all_steps[order]
            stacked = stacked[order]
            if inv is not None:
                stacked = stacked[:, :, inv]
            stacked = stacked[:, :, :n_loc]
            fields = {name: stacked[:, r]
                      for name, r in OUT_FIELD_ROWS.items()}
        return ProductionResult(state=final, out_steps=all_steps,
                                fields=fields, point_steps_per_s=rate,
                                point_range=(lo_eff, lo_eff + n_loc))


def run_production(model: Model, expander, pts: PointParams, cal: Calendar,
                   state: State, *, anchors=None, mesh=None,
                   chunk_t: int = 64, out_stride: Optional[int] = None,
                   bl_iters: int = 40, metrics: Optional[RunMetrics] = None,
                   progress: Optional[Progress] = None,
                   drain: str = "gather") -> ProductionResult:
    """Run the full (uncoupled) forecast through the streamed sharded Pallas
    engine.

    pts/state: [P_real] (padded internally to the mesh x LANE multiple; the
    expander must already be built at the padded count).  anchors: the
    per-point relaxation anchor triple (forcing.relax_anchors), required when
    settings.use_relaxation.  Returns outputs at the global ``out_stride``
    cadence (default settings.output_stride).
    """
    eng = _Engine(model, expander, pts, cal, state, anchors=anchors,
                  mesh=mesh, chunk_t=chunk_t, out_stride=out_stride,
                  bl_iters=bl_iters, metrics=metrics, drain=drain)
    with eng.metrics.phase("compile"):
        eng.compile_range(0, eng.T, False)
    with eng.metrics.phase("stream"):
        t_start = timelib.perf_counter()
        tmp, scal, collected = eng.stream(eng.tmp0, eng.scal0, 0, eng.T,
                                          progress=progress)
        scal.block_until_ready()
        wall = timelib.perf_counter() - t_start
    return eng.assemble(collected, tmp, scal, wall)


def run_production_coupled(model: Model, expander, pts: PointParams,
                           cal: Calendar, state: State, *, anchors=None,
                           mesh=None, chunk_t: int = 64,
                           out_stride: Optional[int] = None,
                           bl_iters: int = 40,
                           metrics: Optional[RunMetrics] = None,
                           progress: Optional[Progress] = None,
                           wchunk: Optional[int] = None,
                           wcache_bytes: Optional[float] = None,
                           drain: str = "gather") -> ProductionResult:
    """Coupled production run: streamed Pallas phases around the
    iteration-major coupling window (coupling.run_window_passes).

    ``wcache_bytes``: device-memory budget for caching the pass-invariant
    phase-B prepared window forcing (expanded once, consumed by every re-run
    pass); default WCACHE_MEM_SHARE of a device's memory, 0 forces per-pass
    recomputation.

    Phase split (1-based steps; ws/we_b from the per-point coupling windows):
      A [1, ws-1]    streamed kernel, coefficients 1
      B [ws, we_b]   ONE jit: unpack -> window passes (first / re-runs /
                     tail) -> repack; forcing expanded on device per chunk
      C [we_b+1, T]  streamed kernel with forcing.cof_window coefficients

    Matches src/Coupling.f90:292-481 semantics via run_window_passes (see
    tests/test_coupling_segmented.py for the engine-level parity chain).
    """
    from .coupling import run_window_passes, window_out_rows

    eng = _Engine(model, expander, pts, cal, state, anchors=anchors,
                  mesh=mesh, chunk_t=chunk_t, out_stride=out_stride,
                  bl_iters=bl_iters, metrics=metrics, drain=drain)
    settings = eng.settings
    T, os_ = eng.T, eng.os_

    start_np = np.asarray(pts.coupling_start)
    end_np = np.asarray(pts.coupling_end)
    coupled_np = (bool(settings.use_coupling) & (end_np >= 1)
                  & (np.asarray(pts.coupling_tsurf) > -100.0))
    have_window = bool(coupled_np.any())
    if have_window:
        ws = max(int(start_np[coupled_np].min()), 1)
        we_b = int(min(end_np[coupled_np].max(), T - 1))
        have_window = ws <= we_b
    if not have_window:
        with eng.metrics.phase("compile"):
            eng.compile_range(0, T, False)
        with eng.metrics.phase("stream"):
            t_start = timelib.perf_counter()
            tmp, scal, col = eng.stream(eng.tmp0, eng.scal0, 0, T,
                                        progress=progress)
            scal.block_until_ready()
            wall = timelib.perf_counter() - t_start
        return eng.assemble(col, tmp, scal, wall)

    W = we_b - ws + 1
    wck = wchunk or min(chunk_t, W)
    rows_b = window_out_rows(ws, we_b, os_)
    # Phase-B window forcing is pass-INVARIANT (only cofs/state change per
    # re-run pass; the reference snapshots its input radiation slices for
    # exactly this reason, src/Coupling.f90:172-255): expand + prepare the
    # window ONCE and have every pass consume the cached prepared chunks --
    # unless the cache would not fit its budget (~38 B/step-point), in which
    # case
    # each pass recomputes its chunks as before (bitwise-identical either
    # way; the provider values are unchanged).
    nv = -(-(W + 1) // wck)
    if wcache_bytes is None:
        wcache_bytes = WCACHE_MEM_SHARE * device_bytes()
    cache_win = 38.0 * nv * wck * eng.P_pad <= float(wcache_bytes)
    eng.metrics.note(
        "coupling window forcing cached once (pass-invariant)" if cache_win
        else f"coupling window forcing recomputed per pass (cache would "
             f"need {38.0 * nv * wck * eng.P_pad / 1e9:.1f} GB)")

    @jax.jit
    def phase_b(tmp, scal, data):
        def provider(t0):
            if eng.fast:
                # station-level prepared channels (bitwise-equal to the
                # generic per-point prep, tests/test_production.py
                # fast-prep parity): each pass's window chunk is only a
                # row gather -- the same trick as the streaming chunks,
                # here cutting the per-pass re-prep cost for windows too
                # big to cache
                pd = data["exp"]["prep"]
                sidx = pd["sidx"]

                def rows(ch):
                    sl = jax.lax.dynamic_slice_in_dim(ch, t0, wck, axis=1)
                    return jnp.take(sl, sidx, axis=0).T       # [wck, P]
                ch = pd["ch"]
                return Prepared(
                    tair=rows(ch[ps.C_TAIR]), vz=rows(ch[ps.C_VZ]),
                    rhz=rows(pd["rhz"]),
                    rain=rows(ch[ps.C_RAIN]), snow=rows(ch[ps.C_SNOW]),
                    sw=rows(ch[ps.C_SW]), lw=rows(ch[ps.C_LW]),
                    tsurf_obs=rows(ch[ps.C_TSURF_OBS]),
                    valid=rows(ch[ps.C_VALID]) != 0.0,
                    in_coupling=rows(ch[ps.C_INCPL]) != 0.0,
                    trf_fric=jax.lax.dynamic_slice_in_dim(
                        pd["trf"], t0, wck))
            rawT = eng.expander.window(data["exp"], t0, wck)
            hr = jax.lax.dynamic_slice_in_dim(data["hour"], t0, wck)
            jd = (jax.lax.dynamic_slice_in_dim(data["jde"], t0, wck)
                  if eng.enable_sky else None)
            return prepare_window(rawT, data["pts"], hr, settings,
                                  eng.params, t_offset=t0, t_total=T,
                                  anchors=data["anchors"], jde=jd,
                                  enable_skyview=eng.enable_sky,
                                  flat_horizons=eng.flat_horizons)

        st = ps.unpack_state(tmp, scal, eng.grid.nlayers, eng.template)
        t0s = ws - 1 + wck * jnp.arange(nv, dtype=jnp.int32)
        if cache_win:
            prep_all = jax.lax.map(provider, t0s)  # leaves [nv, wck, P]
            vw = prep_all.valid

            def provider2(t0):
                k = (t0 - (ws - 1)) // wck
                return jax.tree.map(
                    lambda a: jax.lax.dynamic_index_in_dim(
                        a, k, 0, keepdims=False), prep_all)
        else:
            vw = jax.lax.map(lambda t0: provider(t0).valid, t0s)
            provider2 = provider
        valid_win = vw.reshape(-1, vw.shape[-1])[:W + 1]
        res = run_window_passes(st, provider2, valid_win, ws, we_b,
                                data["pts"], settings, eng.cfg, eng.grid,
                                eng.params, out_stride=os_, wchunk=wck)
        tmp2, scal2 = ps.pack_state(res.state, lpad=tmp.shape[0])
        cst = lambda x: jax.lax.with_sharding_constraint(x, sh_cols(eng.mesh))
        return (cst(tmp2), cst(scal2), res.cv.sw_corr, res.cv.lw_corr,
                jnp.transpose(res.out, (0, 2, 1)).astype(jnp.float32),
                res.reruns)

    with eng.metrics.phase("compile"):
        eng.compile_range(0, ws - 1, False)
        eng.compile_range(we_b, T, True)
        shapes = (jax.ShapeDtypeStruct(eng.tmp0.shape, eng.tmp0.dtype,
                                       sharding=eng.tmp0.sharding),
                  jax.ShapeDtypeStruct(eng.scal0.shape, eng.scal0.dtype,
                                       sharding=eng.scal0.sharding),
                  eng.data_shapes)
        phase_b_c = phase_b.lower(*shapes).compile()

    with eng.metrics.phase("stream"):
        t_start = timelib.perf_counter()
        tmp, scal, col = eng.stream(eng.tmp0, eng.scal0, 0, ws - 1,
                                    progress=progress)
        tmp, scal, sw_corr, lw_corr, out_b, reruns = phase_b_c(
            tmp, scal, eng.data)
        if len(rows_b):
            col.append((list(rows_b), eng._pull(out_b)[:len(rows_b)]))
        if progress:
            progress.update(W)
        tmp, scal, col = eng.stream(tmp, scal, we_b, T,
                                    cofs=(sw_corr, lw_corr),
                                    progress=progress, collected=col)
        scal.block_until_ready()
        wall = timelib.perf_counter() - t_start
    eng.metrics.count("coupling_window_steps", W)
    eng.metrics.count("coupling_reruns", int(reruns))
    return eng.assemble(col, tmp, scal, wall)


def sh_cols(mesh):
    """Sharding for [rows, P]-shaped packed state."""
    return NamedSharding(mesh, P(None, POINTS))

