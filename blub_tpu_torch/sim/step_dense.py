"""The dense-table simulation step and the CFL frame (port of
``blub_tpu/sim/step_dense.py``: ``_step_core`` with ``LocalPhases``,
``frame_dense_fn``, ``frame_dense`` and ``multi_frame_dense``).

One substep, in the reference's pass order (hybrid_fluid.rs:770-977) with the
two rebins that keep the table's bin invariant:

  P2G + fluid count -> marker, normalize, gravity -> divergence RHS ->
  PCG(vel) -> gridfix(remove) -> G2P advect + pack x -> pack y, z (+-2) ->
  P2G density -> density RHS -> PCG(den) -> gridfix(change) ->
  G2P correct + pack x -> pack y, z (+-1)

Each phase runs under ``torch.profiler.record_function`` with the JAX
package's scope names (``ph_*``). The particle count is n0 - lost (only
rebins drop particles), so the rebin's lost accounting needs no table-wide
reduction. A frame picks its substep count from the previous max speed,
clip(ceil(max_speed * dt / cfl), 1, max_substeps) in f32, with one 4-byte
read per frame. With a ``SolidState`` both markers mark occupied cells SOLID,
the divergence RHS takes the moving-wall terms, the velocity gridfix gives
faces into solids the solid velocity, and advect escapes, tests penetration
against the occupancy and pushes (the solids specialisations of the gridfix
and G2P kernels); the density half sees the solids through its marker.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.device import resolve_device
from ..core.types import SimParams, SolidState, SolverStats
from ..ops import g2p, gridfix, p2g, pcg, rebin
from .dense_transfer import density_rhs_from_raw
from .divergence import compute_divergence_rhs
from .slot_major import BYTES_PER_SLOT, SlotMajorTable
from .sm_phases import marker_from_counts
from .table import from_positions


@dataclasses.dataclass
class DenseFluidState:
    """Persistent state of the dense-table simulation; every tensor lives on
    the simulation's device."""

    table: SlotMajorTable
    pressure_vel: torch.Tensor
    pressure_den: torch.Tensor
    step_index: int
    stats_vel: SolverStats
    stats_den: SolverStats
    max_speed: torch.Tensor  # f32 scalar: max |v| (grid/s), drives CFL substepping


def make_dense_state(
    params: SimParams, pos_np, capacity: int = 16, device="cuda"
) -> DenseFluidState:
    """Initial state from seeded positions, on ``device`` (the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    table = from_positions(pos_np, params.grid_dim, capacity, device=dev)
    return DenseFluidState(
        table=table,
        pressure_vel=torch.zeros(params.grid_dim, dtype=torch.float32, device=dev),
        pressure_den=torch.zeros(params.grid_dim, dtype=torch.float32, device=dev),
        step_index=0,
        stats_vel=SolverStats.zero(dev),
        stats_den=SolverStats.zero(dev),
        max_speed=torch.zeros((), dtype=torch.float32, device=dev),
    )


def stage_slack(params: SimParams, capacity: int) -> int:
    x, y, z = params.grid_dim
    return rebin.default_slack(capacity * BYTES_PER_SLOT * x * y * z, capacity)


def step_core(
    params: SimParams, state: DenseFluidState, dt, solids: Optional[SolidState] = None
) -> DenseFluidState:
    """One substep of length ``dt`` (f32), with the voxelized ``solids`` of
    this substep or none."""
    dt = np.float32(dt)
    occupancy = solid_vel = None
    if solids is not None:
        occupancy, solid_vel = solids.occupancy, solids.velocity
        if tuple(occupancy.shape) != tuple(params.grid_dim) or tuple(solid_vel.shape) != (3,) + tuple(params.grid_dim):
            raise ValueError(
                f"solids of shape {tuple(occupancy.shape)} / {tuple(solid_vel.shape)} do not fit the grid "
                f"{tuple(params.grid_dim)}"
            )
    table = state.table
    k = table.capacity
    k_mid = k + stage_slack(params, k)
    grid_dim = params.grid_dim
    n0 = params.num_particles

    with record_function("ph_p2g"):
        acc = p2g.p2g(table.posq, table.dyn)
    with record_function("ph_marker"):
        marker = marker_from_counts(acc[-1], grid_dim, occupancy)
        vel = p2g.normalize_velocity(acc, marker, params.gravity_grid, dt)
    with record_function("ph_div_rhs"):
        rhs = compute_divergence_rhs(vel, marker, solid_vel)
    with record_function("ph_pcg_vel"):
        res_vel = pcg.solve_pressure(state.pressure_vel, rhs, marker, params.solver_vel, dt)
    with record_function("ph_gridfix_vel"):
        vel = gridfix.gridfix_remove(vel, res_vel.pressure, marker, solid_vel)

    lost = table.lost
    with record_function("ph_advect"):
        posq, dyn, max_speed = g2p.advect(table.posq, vel, dt, occupancy, solid_vel)
        posq, dyn, _, _ = rebin.pack(posq, dyn, 0, g2p.ADVECT_SHIFT, k_mid)
    with record_function("ph_rebin2"):
        posq, dyn, lost = rebin.rebin_yz(posq, dyn, g2p.ADVECT_SHIFT, k, lost, n0 - lost)

    with record_function("ph_p2g_density"):
        dacc = p2g.p2g(posq, None, density=True)
    with record_function("ph_den_rhs"):
        marker2 = marker_from_counts(dacc[1], grid_dim, occupancy)
        den_rhs = density_rhs_from_raw(dacc[0], marker2, dt)
    with record_function("ph_pcg_den"):
        res_den = pcg.solve_pressure(state.pressure_den, den_rhs, marker2, params.solver_den, dt)
    with record_function("ph_gridfix_den"):
        change = gridfix.gridfix_change(res_den.pressure, marker2, dt)
    with record_function("ph_correct"):
        posq = g2p.correct(posq, change, marker2)
        posq, dyn, _, _ = rebin.pack(posq, dyn, 0, g2p.CORRECT_SHIFT, k_mid)
    with record_function("ph_rebin1"):
        posq, dyn, lost = rebin.rebin_yz(posq, dyn, g2p.CORRECT_SHIFT, k, lost, n0 - lost)

    return DenseFluidState(
        table=SlotMajorTable(posq=posq, dyn=dyn, lost=lost, grid_dim=table.grid_dim),
        pressure_vel=res_vel.pressure,
        pressure_den=res_den.pressure,
        step_index=state.step_index + 1,
        stats_vel=res_vel.stats,
        stats_den=res_den.stats,
        # position correction leaves velocities alone: the advect by-product
        # is the substep's final max |v|
        max_speed=max_speed,
    )


def substep_count(params: SimParams, state: DenseFluidState, cfl_target: float, max_substeps: int) -> int:
    """clip(ceil(max_speed * dt / cfl), 1, max_substeps) in f32; one 4-byte
    read of the device scalar."""
    if not (cfl_target > 0 and max_substeps > 1):
        return 1
    ms = np.float32(state.max_speed.item())
    cells = ms * np.float32(params.dt) / np.float32(cfl_target)
    return int(min(max(math.ceil(float(cells)), 1), max_substeps))


def frame_dense_fn(
    params: SimParams,
    state: DenseFluidState,
    solids_fn: Callable[[int, int], Optional[SolidState]],
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, int]:
    """One display frame (params.dt of simulated time) as n_sub substeps of
    dt / n_sub; ``solids_fn(i, n_sub)`` gives the solids of substep i of the
    n_sub-way split (or None). Returns (state, n_sub)."""
    n_sub = substep_count(params, state, cfl_target, max_substeps)
    sub_dt = np.float32(params.dt) / np.float32(n_sub)
    for i in range(n_sub):
        state = step_core(params, state, sub_dt, solids_fn(i, n_sub))
    return state, n_sub


def frame_dense(
    params: SimParams,
    state: DenseFluidState,
    solids: Optional[SolidState] = None,
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, int]:
    """``frame_dense_fn`` with the same ``solids`` for every substep."""
    return frame_dense_fn(params, state, lambda i, n: solids, cfl_target, max_substeps)


def multi_frame_dense(
    params: SimParams,
    state: DenseFluidState,
    num_frames: int,
    solids: Optional[SolidState] = None,
    cfl_target: float = 1.9,
    max_substeps: int = 4,
) -> Tuple[DenseFluidState, List[int]]:
    """``num_frames`` CFL frames. Returns (state, n_sub per frame)."""
    n_subs = []
    for _ in range(num_frames):
        state, n = frame_dense(params, state, solids, cfl_target, max_substeps)
        n_subs.append(n)
    return state, n_subs
