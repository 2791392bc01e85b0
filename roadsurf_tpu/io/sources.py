"""Weather data sources and the overlay-merging data handler.

Re-derivation of example1's data plane: GenericSource / GenericSourceFactory /
DataHandler (examples/example1/src/DataHandler.cpp:34-130,
GenericSourceFactory.cpp) and example2's source set (DataSourceFactory.cpp:39-49).

Sources produce per-point arrays on the simulation grid; the handler overlays
them in config order -- later sources overwrite earlier values wherever not
missing (DataHandler.cpp:73-82).  Unlike the reference (per-point virtual
calls), the merged result here is one [P, T] batch per variable feeding the
vectorized device pipeline.
"""
from __future__ import annotations

import dataclasses
import json as jsonlib
import re
import time as timelib
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ModelSettings
from ..forcing import RawForcing, valid_threshold
from .interp import MISSING, interpolate_series

VAR_NAMES = ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw", "sw_dir",
             "lw_net", "tsurf_obs", "prec_phase")

# reference JSON variable names (JsonSource.cpp:196-199)
JSON_VARS = {
    "Temperature 2m": "tair",
    "Humidity": "rhz",
    "DewPoint": "tdew",
    "WindSpeed": "vz",
    "PrecipitationForm": "prec_phase",
    "Precipitation": "prec",
    "RadiationNetSurfaceLW": "lw_net",
    "RadiationLW": "lw",
    "RadiationGlobal": "sw",
    "RadiationDirectSW": "sw_dir",
    "RoadTemperature": "tsurf_obs",
}


def parse_time(s: str, fmt: str = "%Y-%m-%d %H:%M") -> int:
    """Parse a timestamp string to a UTC epoch (the reference uses mktime /
    local time consistently on both sides; we use UTC consistently)."""
    import calendar
    return calendar.timegm(timelib.strptime(s.strip(), fmt))


def parse_times(strings) -> np.ndarray:
    """Vectorized %Y-%m-%d %H:%M epoch parsing (the JsonSource hot path --
    strptime costs ~13 us/call, x ~750k timestamps at production station
    counts); falls back to parse_time row by row on malformed input."""
    if not len(strings):
        return np.zeros(0, np.int64)
    try:
        stripped = [s.strip() for s in strings]
        # only canonical "YYYY-MM-DD HH:MM" takes the lenient vectorized
        # path; anything else (date-only, seconds, ...) must go through the
        # reference's strict strptime format and raise as the C++ does
        if any(len(s) != 16 for s in stripped):
            raise ValueError("non-canonical timestamp shape")
        arr = np.array([s.replace(" ", "T") for s in stripped],
                       dtype="datetime64[s]")
        return arr.astype(np.int64)
    except ValueError:
        return np.array([parse_time(t) for t in strings], np.int64)


def read_json_tolerant(path: str):
    """read_json with comment tolerance (examples/example1/src/JsonTools.cpp):
    strips // line comments (outside string literals).

    Data files are usually comment-free and can be huge (the production
    station files run to hundreds of MB), so the char-level scanner only
    runs on the lines that actually contain ``//``."""
    with open(path) as f:
        text = f.read()
    if "//" not in text:
        return jsonlib.loads(text)
    out_lines = []
    for line in text.splitlines():
        if "//" not in line:
            out_lines.append(line)
            continue
        in_str = False
        i = 0
        while i < len(line):
            c = line[i]
            if in_str and c == "\\":
                i += 2          # skip the escaped character
                continue
            if c == '"':
                in_str = not in_str
            elif not in_str and line[i:i + 2] == "//":
                line = line[:i]
                break
            i += 1
        out_lines.append(line)
    return jsonlib.loads("\n".join(out_lines))


def _complete_tdew_rh(series) -> None:
    """Tdew <-> RH completion (JsonSource.cpp:290-296), batched: ONE device
    call over the concatenation of every station's rows (a per-station call
    costs a device dispatch each)."""
    lens = [len(t) for t, _ in series]
    total = int(np.sum(lens))
    if total == 0:
        return
    cat = {k: np.concatenate([np.asarray(v.get(k, np.full(n, MISSING)))
                              for (_, v), n in zip(series, lens)])
           for k in ("tair", "tdew", "rhz")}
    tair, td, rh = cat["tair"], cat["tdew"], cat["rhz"]
    need_td = (td < -100) & (rh > -100) & (tair > -100)
    need_rh = (rh < -100) & (td > -100) & (tair > -100)
    if not (need_td.any() or need_rh.any()):
        return
    from ..physics.moisture import rh_from_tdew, tdew_from_rh
    if need_td.any():
        td = np.where(need_td, np.asarray(tdew_from_rh(tair, rh)), td)
    if need_rh.any():
        rh = np.where(need_rh, np.asarray(rh_from_tdew(tair, td)), rh)
    off = 0
    for (t, vals), n in zip(series, lens):
        vals["tdew"] = td[off:off + n]
        vals["rhz"] = rh[off:off + n]
        off += n


def batch_interpolate_stations(series, sim_times: np.ndarray):
    """Interpolate many stations' raw series to the simulation grid in one
    native multithreaded call (native/roadsurf_native.cpp
    rs_interpolate_columns; the JsonSource.cpp:49-176 hot path batched over
    stations), with a transparent numpy fallback.

    series: list of (raw_times [R_i] int64, {name: [R_i] float}); returns a
    list of {name: [S]} dicts covering every VAR_NAMES entry.
    """
    from . import native

    S = len(sim_times)
    empty = lambda: {k: np.full(S, MISSING) for k in VAR_NAMES}
    lib = native.load()
    if lib is None or not series:
        out = []
        for t, vals in series:
            if not len(t):
                out.append(empty())
                continue
            interp = interpolate_series(t, sim_times, vals)
            out.append({k: interp.get(k, np.full(S, MISSING))
                        for k in VAR_NAMES})
        return out

    nst = len(series)
    offsets = np.zeros(nst + 1, np.int64)
    for i, (t, _) in enumerate(series):
        offsets[i + 1] = offsets[i] + len(t)
    total = int(offsets[-1])
    raw_times = (np.concatenate([np.asarray(t, np.int64)
                                 for t, _ in series])
                 if total else np.zeros(0, np.int64))
    V = len(VAR_NAMES)
    values = np.full((V, total), MISSING)
    for i, (t, vals) in enumerate(series):
        sl = slice(int(offsets[i]), int(offsets[i + 1]))
        for vi, name in enumerate(VAR_NAMES):
            arr = vals.get(name)
            if arr is not None:
                values[vi, sl] = arr
    miss = np.array([-1000.0 if n == "lw_net" else -100.0
                     for n in VAR_NAMES])
    nn = np.array([1 if n == "prec_phase" else 0 for n in VAR_NAMES],
                  np.int32)
    res = native.interpolate_columns(offsets, raw_times, sim_times, values,
                                     miss, nn)
    return [{name: res[i, vi] for vi, name in enumerate(VAR_NAMES)}
            for i in range(nst)]


@dataclasses.dataclass
class StationData:
    """One station's data interpolated to the simulation grid."""
    point_id: int
    lat: float
    lon: float
    values: Dict[str, np.ndarray]   #: name -> [T] on the sim grid


class Source:
    """Base class (GenericSource, examples/example1/src/GenericSource.h)."""

    is_observation = False

    def stations(self) -> List[StationData]:
        raise NotImplementedError


class JsonSource(Source):
    """example1 JSON station files (JsonSource.cpp:183-316): per-station time
    series, Tdew<->RH completion, interpolation to the simulation grid."""

    def __init__(self, path: str, sim_times: np.ndarray,
                 is_observation: bool = False, data=None):
        self.is_observation = is_observation
        doc = data if data is not None else read_json_tolerant(path)
        series, meta = [], []
        for st in doc:
            times = parse_times(st.get("time", []))
            vals = {}
            n = len(times)
            for jname, name in JSON_VARS.items():
                arr = st.get(jname)
                if arr is not None:
                    vals[name] = np.asarray(arr, np.float64)
                else:
                    vals[name] = np.full(n, MISSING)
            series.append((times, vals))
            meta.append((int(st.get("statId", 0)),
                         float(st.get("lat", MISSING)),
                         float(st.get("lon", MISSING))))
        _complete_tdew_rh(series)
        interped = batch_interpolate_stations(series, sim_times)
        self._stations = [StationData(pid, lat, lon, values)
                          for (pid, lat, lon), values in zip(meta, interped)]

    def stations(self):
        return self._stations


class AsciiSource(Source):
    """example2 fixed-column ASCII observation rows
    (examples/example2/src/AsciiSource.cpp): per line
    ``yy mm dd hh tair rh vz rr1h rform srad lrad tsurf`` for a single
    station; lat/lon/id given in the source config."""

    _COLS = ("tair", "rhz", "vz", "prec", "prec_phase", "sw", "lw",
             "tsurf_obs")

    def __init__(self, path: str, sim_times: np.ndarray, point_id: int,
                 lat: float, lon: float, is_observation: bool = True):
        self.is_observation = is_observation
        epochs, cols = self._parse(path)
        if len(epochs):
            order = np.argsort(epochs)
            epochs = epochs[order]
            vals = {name: cols[k][order]
                    for k, name in enumerate(self._COLS)}
            interp = interpolate_series(epochs, sim_times, vals)
        else:
            interp = {k: np.full(len(sim_times), MISSING)
                      for k in self._COLS}
        full = {k: interp.get(k, np.full(len(sim_times), MISSING))
                for k in VAR_NAMES}
        self._stations = [StationData(point_id, lat, lon, full)]

    @staticmethod
    def _parse(path: str):
        """Parse rows; uses the native C++ parser when built (native/),
        falling back to Python."""
        from . import native
        with open(path, "rb") as f:
            blob = f.read()
        if native.load() is not None:
            epochs, vals = native.parse_ascii_obs(blob)
            return epochs, vals
        rows = []
        import calendar
        epochs = []
        for line in blob.decode().splitlines():
            parts = line.split()
            if len(parts) < 12 or parts[0].startswith("#"):
                continue
            f12 = [float(x) for x in parts[:12]]
            y = int(f12[0])
            epochs.append(calendar.timegm(
                (y if y > 100 else 2000 + y, int(f12[1]), int(f12[2]),
                 int(f12[3]), 0, 0, 0, 0, 0)))
            rows.append(f12[4:12])
        a = (np.asarray(rows, np.float64).T if rows
             else np.zeros((8, 0)))
        return np.asarray(epochs, np.int64), a

    def stations(self):
        return self._stations


class RoadSurfSource(Source):
    """Warm start from a previous run's output (the rolling forecast cycle;
    examples/example2/src/RoadSurfSource.cpp:516-616): the previous cycle's
    road temperature becomes this cycle's TSurfObs input."""

    def __init__(self, path: str, sim_times: np.ndarray,
                 is_observation: bool = True, max_gap_minutes: float = 180.0):
        self.is_observation = is_observation
        doc = read_json_tolerant(path)
        self._stations = []
        for st in doc:
            times = np.array([parse_time(t, "%Y-%m-%dT%H:%M")
                              for t in st.get("time", [])], np.int64)
            vals = np.asarray(st.get("RoadTemperature", []), np.float64)
            # skip-missing interpolation with the 180-min gap cap
            # (examples/example2/src/RoadSurfSource.cpp:449-507, :555)
            from .interp import interpolate_gap_capped
            full = {k: np.full(len(sim_times), MISSING) for k in VAR_NAMES}
            full["tsurf_obs"] = interpolate_gap_capped(
                times, sim_times, vals, max_gap_minutes=max_gap_minutes)
            self._stations.append(StationData(
                point_id=int(st.get("statId", 0)),
                lat=float(st.get("lat", MISSING)),
                lon=float(st.get("lon", MISSING)), values=full))

    def stations(self):
        return self._stations


def create_source(cfg: dict, sim_times: np.ndarray) -> Source:
    """Source factory (GenericSourceFactory.cpp; example2
    DataSourceFactory.cpp:39-49)."""
    typ = cfg.get("type", "json")
    is_obs = cfg.get("source") == "observations"
    if typ == "json":
        return JsonSource(cfg["path"], sim_times, is_observation=is_obs)
    if typ == "ascii":
        return AsciiSource(cfg["path"], sim_times,
                           point_id=int(cfg.get("statId", 0)),
                           lat=float(cfg.get("lat", MISSING)),
                           lon=float(cfg.get("lon", MISSING)))
    if typ.lower() == "roadsurf":
        return RoadSurfSource(
            cfg["path"], sim_times,
            max_gap_minutes=float(cfg.get("max_gap_minutes", 180.0)))
    if typ == "smartmet":
        from .smartmet import SmartMetSource
        return SmartMetSource(cfg, sim_times,
                              is_observation=cfg.get("source",
                                                     "observations")
                              == "observations")
    if typ in ("grid", "file", "directory"):
        # example2 querydata types 'file'/'directory'
        # (DataSourceFactory.cpp:39-44) -> the gridded npz source
        from .gridsource import GridSource
        return GridSource(cfg, sim_times, is_observation=is_obs)
    raise ValueError(f"Unknown input type: '{typ}'")


class DataHandler:
    """Ordered source list + per-value overlay merge
    (examples/example1/src/DataHandler.cpp:34-130)."""

    def __init__(self, sources: Sequence[Source]):
        self.sources = list(sources)

    @classmethod
    def from_config(cls, config: dict, sim_times: np.ndarray) -> "DataHandler":
        srcs = [create_source(c, sim_times) for c in config.get("input", [])]
        return cls(srcs)

    def point_ids(self) -> List[int]:
        """Point ids from the first source (DataHandler.cpp:88-95)."""
        if not self.sources:
            return []
        return [s.point_id for s in self.sources[0].stations()]

    def locations(self):
        if not self.sources:
            return []
        return [(s.lat, s.lon) for s in self.sources[0].stations()]

    def merged(self, sim_len: int):
        """Overlay-merge all sources into [P, T] arrays keyed by the first
        source's point ids.  Returns (RawForcing, obs_tair [P, T])."""
        ids = self.point_ids()
        P = len(ids)
        data = {k: np.full((P, sim_len), MISSING) for k in VAR_NAMES}
        obs_tair = np.full((P, sim_len), MISSING)
        index = {pid: i for i, pid in enumerate(ids)}
        for src in self.sources:
            for st in src.stations():
                row = index.get(st.point_id)
                if row is None:
                    continue
                for name in VAR_NAMES:
                    v = st.values.get(name)
                    if v is None:
                        continue
                    valid = v > valid_threshold(name)
                    data[name][row] = np.where(valid, v, data[name][row])
                    if name == "tair" and src.is_observation:
                        obs_tair[row] = np.where(valid, v, obs_tair[row])
        phase = np.where(data["prec_phase"] > -100,
                         data["prec_phase"], -9999).astype(np.int64)
        raw = RawForcing(
            tair=data["tair"], tdew=data["tdew"], vz=data["vz"],
            rhz=data["rhz"], prec=data["prec"], sw=data["sw"], lw=data["lw"],
            sw_dir=data["sw_dir"], lw_net=data["lw_net"],
            tsurf_obs=data["tsurf_obs"], prec_phase=phase)
        return raw, obs_tair

    def has_grid_source(self) -> bool:
        return any(hasattr(s, "at_points") for s in self.sources)

    def merged_at_points(self, plat, plon, sim_len: int,
                         max_radius_km: float = 50.0):
        """Latlon-keyed overlay merge -- example2's DataManager::GetWeather
        semantics (examples/example2/src/DataManager.cpp:67-77): each source
        is queried at the simulation points and later sources overwrite
        earlier values where valid.  Grid sources interpolate bilinearly;
        station sources contribute via their nearest station within
        ``max_radius_km`` (the RoadSurfSource NearTree radius pattern,
        RoadSurfSource.cpp:516-616).

        Returns (RawForcing [P, T], obs_tair [P, T])."""
        plat = np.asarray(plat, np.float64)
        plon = np.asarray(plon, np.float64)
        P = len(plat)
        data = {k: np.full((P, sim_len), MISSING) for k in VAR_NAMES}
        obs_tair = np.full((P, sim_len), MISSING)
        for src in self.sources:
            if hasattr(src, "at_points"):
                vals = src.at_points(plat, plon)
                for name, v in vals.items():
                    valid = v > valid_threshold(name)
                    data[name] = np.where(valid, v, data[name])
                    if name == "tair" and src.is_observation:
                        obs_tair = np.where(valid, v, obs_tair)
                continue
            sts = src.stations()
            if not sts:
                continue
            from .points import haversine_km
            st_lats = np.array([s.lat for s in sts])
            st_lons = np.array([s.lon for s in sts])
            d = haversine_km(plat[:, None], plon[:, None],
                             st_lats[None, :], st_lons[None, :])
            idx = np.argmin(d, axis=1)
            ok = d[np.arange(P), idx] <= max_radius_km
            for name in VAR_NAMES:
                sv = np.stack([np.asarray(s.values.get(
                    name, np.full(sim_len, MISSING))) for s in sts])
                v = sv[idx]
                valid = ((v > (-1000.0 if name == "lw_net" else -100.0))
                         & ok[:, None])
                data[name] = np.where(valid, v, data[name])
                if name == "tair" and src.is_observation:
                    obs_tair = np.where(valid, v, obs_tair)
        phase = np.where(data["prec_phase"] > -100,
                         data["prec_phase"], -9999).astype(np.int64)
        raw = RawForcing(
            tair=data["tair"], tdew=data["tdew"], vz=data["vz"],
            rhz=data["rhz"], prec=data["prec"], sw=data["sw"], lw=data["lw"],
            sw_dir=data["sw_dir"], lw_net=data["lw_net"],
            tsurf_obs=data["tsurf_obs"], prec_phase=phase)
        return raw, obs_tair
