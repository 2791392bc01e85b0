"""roadsurf_tpu: a road weather model framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of fmidev/RoadSurf
(the FMI road weather model library): per-point 1-D ground heat balance with
surface storage physics, observation coupling, relaxation, sky-view radiation
correction -- batched over millions of road points, scanned over time on a
GPU, sharded over device meshes.
"""
import os

from .config import ModelSettings, PhysicsParams
from .forcing import Calendar, Prepared, RawForcing
from .model import Model, SimOutput, scan_steps
from .state import PointParams, State, default_point_params, init_state

__version__ = "0.1.0"

#: the checkout's persistent compile cache (used unless
#: JAX_COMPILATION_CACHE_DIR names another)
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def use_compile_cache() -> str:
    """Keep JAX's persistent compile cache across processes: where
    JAX_COMPILATION_CACHE_DIR is set JAX uses it as it stands, otherwise the
    cache lives in COMPILE_CACHE_DIR.  Call before the first compile;
    returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR

__all__ = [
    "ModelSettings", "PhysicsParams", "Calendar", "Prepared", "RawForcing",
    "Model", "SimOutput", "scan_steps", "PointParams", "State",
    "default_point_params", "init_state", "use_compile_cache",
]
