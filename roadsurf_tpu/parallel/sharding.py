"""Point-axis sharding over a device mesh.

The reference's entire parallel structure is embarrassingly-parallel CPU
threading over independent road points (examples/example1/src/WorkQueue.h:15-131,
examples/example2 boost::asio pool).  The device equivalent: one
``jax.sharding.Mesh`` with a ``points`` axis; every [P]-leading array carries a
``NamedSharding(P('points'))`` and XLA runs the batched scan with zero
communication (columns are independent).  Collectives appear only for global
metrics/validation reductions (psum) and the missing-data budget -- the
analogue of example2's allowed_missing_ratio guard
(examples/example2/src/roadrunner.cpp:700-706).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

POINTS = "points"


def make_mesh(devices=None, axis_name: str = POINTS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def _spec_for(leaf, axis: int) -> P:
    ndim = jnp.ndim(leaf)
    spec = [None] * ndim
    if ndim > axis:
        spec[axis] = POINTS
    return P(*spec)


def shard_state(tree, mesh: Mesh):
    """Shard a State/PointParams-like pytree on its leading (points) axis."""
    return jax.device_put(
        tree, jax.tree.map(
            lambda x: NamedSharding(mesh, _spec_for(x, 0)), tree))


def shard_prepared(prep, mesh: Mesh):
    """Shard time-major [T, P] forcing channels on axis 1; [T] channels are
    replicated."""
    def put(x):
        spec = P(None, POINTS) if jnp.ndim(x) >= 2 else P(None)
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, prep)


def pad_points(tree, multiple: int, axis: int = 0):
    """Pad the points axis to a device-count multiple.  Padded points are
    marked failed by the caller (validity mask), so they never contribute.
    Returns (padded_tree, original_count)."""
    def pad(x):
        x = np.asarray(x)
        if x.ndim <= axis:
            return x
        n = x.shape[axis]
        rem = (-n) % multiple
        if rem == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, rem)
        return np.pad(x, widths, mode="edge")
    first = jax.tree.leaves(tree)[0]
    return jax.tree.map(pad, tree), np.asarray(first).shape[axis]


def pallas_scan_sharded(tmp0, scal0, forcing, cfg, params, grid,
                        mesh: Mesh, out_stride: int = 1, bl_iters: int = 40,
                        interpret: bool = False, nsteps: Optional[int] = None,
                        out_offset=None, n_out: Optional[int] = None,
                        t_total: Optional[int] = None,
                        cof_red: Optional[float] = None,
                        slim_trf=None, aux_rows=None,
                        aux_cofs: bool = False):
    """The fused Pallas forecast kernel over a points-sharded device mesh.

    This is the production multi-device path: ``shard_map`` hands each
    device its own contiguous block of road points and launches the
    whole-scan kernel locally -- zero collectives in the hot loop (columns
    are independent, the batched re-design of the reference's per-point
    thread pool,
    examples/example1/src/WorkQueue.h:15-131).  Layouts match
    ops.pallas_step.pallas_scan: tmp0 [LPAD, P], scal0 [NROWS, P],
    forcing [T, NCH, P]; the points axis of each is sharded over ``mesh``.

    Returns (tmp_final [LPAD, P], scal_final [NROWS, P],
    out [n_out, N_OUT_FIELDS, P]) with the same shardings.
    """
    from ..ops.pallas_step import pallas_scan

    ndev = int(np.prod(mesh.devices.shape))
    n_points = tmp0.shape[1]
    if n_points % ndev:
        raise ValueError(
            f"points ({n_points}) must divide the mesh ({ndev} devices); "
            "pad with pad_points() first")
    from ..ops.pallas_step import LANE
    per_shard = n_points // ndev
    if per_shard % LANE:
        raise ValueError(
            f"per-device points ({per_shard} = {n_points}/{ndev}) must be a "
            f"multiple of the kernel lane width ({LANE}); pad with "
            f"pad_points(tree, {ndev * LANE}) first")

    if out_offset is None:
        eff_steps = forcing.shape[0] if nsteps is None else nsteps
        n_out = -(-eff_steps // out_stride)
        out_offset = 0
    else:
        assert n_out is not None, "out_offset requires an explicit n_out"

    slim = aux_rows is not None

    def local(tmp, scal, forc, off, *extra):
        kw = {}
        if slim:
            kw["slim_trf"], kw["aux_rows"] = extra[0], extra[1]
            kw["aux_cofs"] = aux_cofs
        return pallas_scan(tmp, scal, forc, cfg, params, grid,
                           out_stride=out_stride, bl_iters=bl_iters,
                           interpret=interpret, nsteps=nsteps,
                           out_offset=off, n_out=n_out,
                           t_total=t_total, cof_red=cof_red, **kw)

    # tile-major fused-expansion forcing [n_tiles, T, NCH, subl, LANE] is
    # sharded on its TILE dim (tiles subdivide each device's point block)
    forc_spec = (P(POINTS, None, None, None, None) if forcing.ndim == 5
                 else P(None, None, POINTS))
    if forcing.ndim == 5 and forcing.shape[0] % ndev:
        raise ValueError(
            f"tile count ({forcing.shape[0]}) must divide the mesh ({ndev})")
    in_specs = [P(None, POINTS), P(None, POINTS), forc_spec, P()]
    args = [tmp0, scal0, forcing, jnp.asarray(out_offset, jnp.int32)]
    if slim:
        in_specs += [P(), P(None, POINTS)]
        args += [slim_trf, aux_rows]
    shard = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=(P(None, POINTS), P(None, POINTS), P(None, None, POINTS)),
        check_vma=False)  # pallas_call out_shapes carry no vma annotation
    return shard(*args)


def failure_stats(failed, mesh: Optional[Mesh] = None):
    """Global failed-point count + ratio via psum over the mesh -- the
    missing-data budget reduction (examples/example2/src/roadrunner.cpp:536-543).

    ``failed``: sharded [P] bool.  Returns (count, ratio) as scalars.
    """
    if mesh is None:
        n = failed.sum()
        return n, n / failed.shape[0]

    @jax.jit
    def stats(fl):
        def local(fl_shard):
            cnt = jnp.sum(fl_shard.astype(jnp.int32))
            return jax.lax.psum(cnt, POINTS)
        f = jax.shard_map(local, mesh=mesh, in_specs=(P(POINTS),),
                          out_specs=P())
        total = f(fl)
        return total, total / fl.shape[0]

    return stats(failed)


def check_missing_budget(failed, allowed_missing_ratio: float,
                         mesh: Optional[Mesh] = None) -> bool:
    """True if the run exceeds the allowed failure budget (the reference
    raises a hard error then; example2/src/roadrunner.cpp:578-581)."""
    _, ratio = failure_stats(failed, mesh)
    return bool(ratio > allowed_missing_ratio)
