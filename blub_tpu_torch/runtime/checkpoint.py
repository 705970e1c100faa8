"""Simulation checkpoint/resume (port of ``blub_tpu/runtime/checkpoint.py``).

The reference has none: recovery is "reset scene" (SURVEY.md section 5.4).
A checkpoint is one .npz in the JAX package's format: ``__meta__`` (JSON:
version, scene name, simulated time, number of leaves, extra) and
``leaf_<i>``, the leaves of a slot-major ``DenseFluidState`` in JAX's pytree
order, written and read through ``convert.py`` (``STATE_LEAVES``: the table
as f32 bit patterns padded along z to 128 lanes, the pressures, the step
index, the solver stats, the max speed). A checkpoint of either package
loads in the other for a state in the scene's own axis order. The port runs
only that layout: a JAX checkpoint of its "pt" particle-table state or of an
axis-permuted state raises, naming the layout.
"""

from __future__ import annotations

import json
import pathlib
from typing import Tuple

import numpy as np

from .. import convert
from ..sim.step_dense import DenseFluidState

CHECKPOINT_VERSION = 1


def save_checkpoint(path, state: DenseFluidState, *, scene_name: str = "", total_simulated_time: float = 0.0,
                    extra: dict | None = None) -> pathlib.Path:
    """Write the full simulation state to one .npz file."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = convert.state_leaves(state)
    meta = {
        "version": CHECKPOINT_VERSION,
        "scene_name": scene_name,
        "total_simulated_time": total_simulated_time,
        "num_leaves": len(leaves),
        "extra": extra or {},
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    return path


def _check_layout(leaves, like: DenseFluidState) -> None:
    """Raise, naming the layout, unless ``leaves`` are a slot-major state in
    the scene's own axis order with ``like``'s capacity."""
    grid = tuple(like.table.grid_dim)
    if len(leaves) != len(convert.STATE_LEAVES):
        table = leaves[0].shape if leaves else ()
        kind = ('the JAX package\'s "pt" particle-table layout' if len(leaves) == 13 and table[-1:] == (3,)
                else "an unknown layout")
        raise ValueError(f"checkpoint state has {len(leaves)} leaves (table leaf of shape {table}): {kind}; the "
                         f'port takes the slot-major ("sm") layout in the scene\'s axis order, '
                         f"{len(convert.STATE_LEAVES)} leaves")
    pgrid = tuple(leaves[3].shape)
    if pgrid != grid:
        kind = ("an axis-permuted slot-major layout (the JAX package's axis_layout='auto')"
                if sorted(pgrid) == sorted(grid) else "another grid")
        raise ValueError(f"checkpoint grid {pgrid} is {kind}, not the scene's grid {grid} in its own axis order; "
                         "write it with axis_layout='identity'")
    want = (like.table.capacity, 2) + grid[:2] + (convert.zpad(grid[2]),)
    if tuple(leaves[0].shape) != want:
        raise ValueError(f"checkpoint table of shape {tuple(leaves[0].shape)}, expected the slot-major {want}")


def load_checkpoint(path, state_like: DenseFluidState) -> Tuple[DenseFluidState, dict]:
    """Restore a state on ``state_like``'s device (its grid and capacity
    must match). Returns (state, metadata)."""
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta["version"] != CHECKPOINT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} != {CHECKPOINT_VERSION}")
        leaves = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    _check_layout(leaves, state_like)
    state = convert.state_from_leaves(leaves, state_like.table.grid_dim, device=state_like.pressure_vel.device)
    return state, meta


def save_scene(scene, path) -> pathlib.Path:
    return save_checkpoint(path, scene.state, scene_name=scene.config.name,
                           total_simulated_time=scene.total_simulated_time)


def load_scene_checkpoint(scene, path) -> None:
    """Load a checkpoint into ``scene`` (on the card, the next frame copies
    it into the frame graphs' static state). Raises for another scene."""
    state, meta = load_checkpoint(path, scene.state)
    if meta["scene_name"] and meta["scene_name"] != scene.config.name:
        raise ValueError(f"checkpoint is for scene {meta['scene_name']!r}, not {scene.config.name!r}")
    scene.state = state
    scene.total_simulated_time = float(meta["total_simulated_time"])
