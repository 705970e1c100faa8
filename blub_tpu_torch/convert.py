"""State bridge between the JAX package and the port, in numpy (no JAX).

The JAX package keeps its slot-major table as f32 bit patterns padded along z
to a multiple of 128 lanes (``posq f32[K,2,X,Y,Zp]``, ``dyn f32[K,6,X,Y,Zp]``).
The port keeps the same bits as int32 without the padding. ``from_jax``
takes the JAX fields as numpy arrays (``np.asarray(sm.posq)`` etc.) and
returns the port's state; ``to_jax`` returns numpy arrays in the JAX layout,
ready for ``jnp.asarray``. Both directions are bit-exact. Solids map the
JAX ``SolidState`` (velocity [X,Y,Z,3]) to and from the port's (velocity
[3,X,Y,Z]). ``state_leaves`` / ``state_from_leaves`` give a whole state as
the JAX package's pytree leaves of a slot-major ``DenseFluidState``, in its
order (the checkpoint format, ``runtime/checkpoint.py``). ``slab_state_from_jax``
gives one rank's x-slab of a JAX state (the mesh path,
``parallel/sharded_sm.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .core.types import SolidState, SolverStats
from .sim.slot_major import SlotMajorTable, zpad  # noqa: F401  (zpad: also the checkpoint's)
from .sim.step_dense import DenseFluidState


def table_from_jax(posq, dyn, lost, grid_dim, device="cuda") -> SlotMajorTable:
    """JAX ``SlotMajorTable`` fields (numpy) -> port table."""
    dev = resolve_device(device)
    z = grid_dim[2]
    pq = np.ascontiguousarray(np.asarray(posq, np.float32)[..., :z]).view(np.int32)
    dy = np.ascontiguousarray(np.asarray(dyn, np.float32)[..., :z]).view(np.int32)
    return SlotMajorTable(
        posq=torch.from_numpy(pq.copy()).to(dev),
        dyn=torch.from_numpy(dy.copy()).to(dev),
        lost=torch.tensor(int(np.asarray(lost)), dtype=torch.int32, device=dev),
        grid_dim=tuple(int(v) for v in grid_dim),
    )


def table_to_jax(table: SlotMajorTable):
    """Port table -> dict of numpy arrays in the JAX layout (posq/dyn f32 bit
    patterns zero-padded to Zp, lost int32)."""
    z = table.grid_dim[2]
    pad = zpad(z) - z

    def padded(a):
        a = a.detach().cpu().numpy()
        a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        return a.view(np.float32)

    return {
        "posq": padded(table.posq),
        "dyn": padded(table.dyn),
        "lost": np.int32(table.lost.item()),
        "grid_dim": tuple(table.grid_dim),
    }


def state_from_jax(
    posq, dyn, lost, grid_dim, pressure_vel, pressure_den, max_speed,
    step_index=0, device="cuda",
) -> DenseFluidState:
    """JAX ``DenseFluidState`` fields (numpy) -> port state."""
    dev = resolve_device(device)
    table = table_from_jax(posq, dyn, lost, grid_dim, device=dev)

    def grid(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    return DenseFluidState(
        table=table,
        pressure_vel=grid(pressure_vel),
        pressure_den=grid(pressure_den),
        step_index=torch.tensor(int(np.asarray(step_index)), dtype=torch.int32, device=dev),
        stats_vel=SolverStats.zero(dev),
        stats_den=SolverStats.zero(dev),
        max_speed=torch.tensor(float(np.asarray(max_speed)), dtype=torch.float32, device=dev),
    )


def state_to_jax(state: DenseFluidState):
    """Port state -> dict of numpy arrays in the JAX layout."""
    out = table_to_jax(state.table)
    out["pressure_vel"] = state.pressure_vel.detach().cpu().numpy()
    out["pressure_den"] = state.pressure_den.detach().cpu().numpy()
    out["max_speed"] = np.float32(state.max_speed.item())
    out["step_index"] = np.int32(int(state.step_index))
    return out


# the leaves of the JAX package's slot-major DenseFluidState, in
# jax.tree_util order: table (posq, dyn, lost), pressure_vel, pressure_den,
# step_index, stats_vel (error, iterations), stats_den (error, iterations),
# max_speed
STATE_LEAVES = ("posq", "dyn", "lost", "pressure_vel", "pressure_den", "step_index", "error_vel",
                "iterations_vel", "error_den", "iterations_den", "max_speed")


def state_leaves(state: DenseFluidState) -> list:
    """Port state -> the numpy leaves of the JAX package's slot-major
    ``DenseFluidState`` (``STATE_LEAVES``, in the JAX layout and dtypes)."""
    out = state_to_jax(state)
    stats = (state.stats_vel.error, state.stats_vel.iterations, state.stats_den.error, state.stats_den.iterations)
    err_vel, it_vel, err_den, it_den = (a.detach().cpu().numpy() for a in stats)
    return [out["posq"], out["dyn"], out["lost"], out["pressure_vel"], out["pressure_den"], out["step_index"],
            np.float32(err_vel), np.int32(it_vel), np.float32(err_den), np.int32(it_den), out["max_speed"]]


def state_from_leaves(leaves, grid_dim, device="cuda") -> DenseFluidState:
    """The numpy leaves of a JAX slot-major ``DenseFluidState`` (as
    ``state_leaves`` gives them) -> port state, bit for bit."""
    lv = dict(zip(STATE_LEAVES, leaves))
    state = state_from_jax(lv["posq"], lv["dyn"], lv["lost"], grid_dim, lv["pressure_vel"], lv["pressure_den"],
                           lv["max_speed"], step_index=int(lv["step_index"]), device=device)
    dev = state.pressure_vel.device

    def scalar(a, dtype):
        return torch.from_numpy(np.array(a, dtype).reshape(())).to(dev)

    for name in ("vel", "den"):
        stats = SolverStats(error=scalar(lv[f"error_{name}"], np.float32),
                            iterations=scalar(lv[f"iterations_{name}"], np.int32))
        setattr(state, f"stats_{name}", stats)
    return state


def solids_from_jax(occupancy, velocity, device="cuda") -> SolidState:
    """JAX ``SolidState`` fields (numpy; velocity [X,Y,Z,3]) -> port
    ``SolidState`` (velocity [3,X,Y,Z])."""
    dev = resolve_device(device)
    occ = np.array(occupancy, np.float32)
    vel = np.ascontiguousarray(np.moveaxis(np.asarray(velocity, np.float32), -1, 0))
    return SolidState(occupancy=torch.from_numpy(occ).to(dev), velocity=torch.from_numpy(vel).to(dev))


def solids_to_jax(solids: SolidState):
    """Port ``SolidState`` -> dict of numpy arrays in the JAX layout."""
    return {
        "occupancy": solids.occupancy.detach().cpu().numpy(),
        "velocity": np.ascontiguousarray(np.moveaxis(solids.velocity.detach().cpu().numpy(), 0, -1)),
    }


def dense_state_from_jax(state, solids=None, device="cuda"):
    """A JAX ``DenseFluidState`` on the slot-major layout, and a JAX
    ``SolidState`` or None -> (port state, port solids or None). Reads the
    fields through ``np.asarray``."""
    t = state.table
    port = state_from_jax(
        np.asarray(t.posq), np.asarray(t.dyn), np.asarray(t.lost), t.grid_dim,
        np.asarray(state.pressure_vel), np.asarray(state.pressure_den), np.asarray(state.max_speed),
        step_index=int(np.asarray(state.step_index)), device=device,
    )
    if solids is None:
        return port, None
    return port, solids_from_jax(np.asarray(solids.occupancy), np.asarray(solids.velocity), device=device)


def slab_state_from_jax(posq, dyn, lost, grid_dim, pressure_vel, pressure_den, max_speed, rank: int, n: int,
                        step_index=0, device="cuda") -> DenseFluidState:
    """JAX ``DenseFluidState`` fields (numpy, the whole grid) -> rank
    ``rank``'s x-slab of the port state on an n-rank mesh
    (``parallel/sharded_sm.py``; as its ``shard_sm_state`` cuts a port
    state), bit for bit. The scalars are the whole state's."""
    x, y, z = (int(v) for v in grid_dim)
    if x % n:
        raise ValueError(f"an x extent of {x} does not split over {n} ranks")
    xl = x // n
    sl = slice(rank * xl, (rank + 1) * xl)
    return state_from_jax(
        np.asarray(posq)[:, :, sl], np.asarray(dyn)[:, :, sl], lost, (xl, y, z), np.asarray(pressure_vel)[sl],
        np.asarray(pressure_den)[sl], max_speed, step_index=step_index, device=device,
    )
