"""Simulation controller + timer: fixed-timestep pacing, pause, fast-forward,
recording (copy of ``blub_tpu/runtime/controller.py``; the analogs of
src/simulation_controller.rs and src/timer.rs).

A compute card runs no display watchdog, so the reference's 16-step TDR
batching becomes "fast-forward runs big batches", each bounded by one
blocking ``solver_stats()`` read; the realtime accumulator loop (fixed dt,
drop steps when over budget) is kept because it defines the product
behavior (default 120 steps/s, give up at 20 ms sim per frame:
simulation_controller.rs:31-39, timer.rs:94-120).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Deque, Optional

from .scene import Scene


class SimulationControllerStatus(enum.Enum):
    REALTIME = "realtime"
    RECORDING = "recording"  # fixed frame length
    FAST_FORWARD = "fast_forward"
    PAUSED = "paused"


@dataclasses.dataclass
class FrameStats:
    sim_steps: int
    sim_seconds: float
    wall_seconds: float


class SimulationController:
    """Drives a Scene at a fixed simulation rate against wall-clock frames."""

    # Give up on realtime if sim compute alone exceeds this per frame
    # (simulation_controller.rs:31).
    MAX_TOTAL_STEP_SECONDS_PER_FRAME = 1.0 / 50.0
    # Drop most of the residual lag instead of oscillating (timer.rs:110-120).
    LAG_DROP_FRACTION = 0.9

    def __init__(self, scene: Scene, recording_frame_length: float = 1.0 / 60.0):
        self.scene = scene
        self.status = SimulationControllerStatus.REALTIME
        self.simulation_stop_time: Optional[float] = None  # sim seconds
        self.time_scale = 1.0
        self.recording_frame_length = recording_frame_length
        self.frame_history: Deque[FrameStats] = deque(maxlen=50)
        self._accumulator = 0.0
        self._last_frame_wall: Optional[float] = None
        self.total_steps = 0

    @property
    def dt(self) -> float:
        return self.scene.settings.dt

    def pause_or_resume(self) -> None:
        if self.status == SimulationControllerStatus.PAUSED:
            self.status = SimulationControllerStatus.REALTIME
            self._last_frame_wall = None
        else:
            self.status = SimulationControllerStatus.PAUSED

    def restart(self) -> None:
        self.scene.reset()
        self._accumulator = 0.0
        self.total_steps = 0
        self._last_frame_wall = None

    def frame_steps(self) -> FrameStats:
        """Run the simulation steps owed for one rendered frame."""
        now = time.monotonic()
        if self.status == SimulationControllerStatus.PAUSED:
            self._last_frame_wall = now
            return self._record(FrameStats(0, 0.0, 0.0))

        if self.status == SimulationControllerStatus.RECORDING:
            frame_delta = self.recording_frame_length
        else:
            frame_delta = (now - self._last_frame_wall) if self._last_frame_wall else self.dt
        self._last_frame_wall = now
        self._accumulator += frame_delta * self.time_scale

        steps = 0
        t0 = time.monotonic()
        while self._accumulator >= self.dt:
            if self._stopped():
                self._accumulator = 0.0
                break
            self.scene.step()
            steps += 1
            self.total_steps += 1
            self._accumulator -= self.dt
            if time.monotonic() - t0 > self.MAX_TOTAL_STEP_SECONDS_PER_FRAME:
                # over budget: drop most of the remaining lag (timer.rs:110-120)
                self._accumulator *= 1.0 - self.LAG_DROP_FRACTION
                break
        return self._record(FrameStats(steps, steps * self.dt, time.monotonic() - t0))

    def fast_forward(self, sim_seconds: float, batch: int = 64) -> FrameStats:
        """Advance the simulation by a fixed amount of simulated time as fast
        as possible (fast_forward_steps, simulation_controller.rs:96-157)."""
        n = int(round(sim_seconds / self.dt))
        prev = self.status
        self.status = SimulationControllerStatus.FAST_FORWARD
        t0 = time.monotonic()
        done = 0
        while done < n:
            k = min(batch, n - done)
            for _ in range(k):
                if self._stopped():
                    n = done
                    break
                self.scene.step()
                done += 1
                self.total_steps += 1
            # read the stats (blocking) to bound the work in flight (the
            # reference blocks on the GPU every 16 steps for the same reason)
            self.scene.solver_stats()
        self.status = prev
        return self._record(FrameStats(done, done * self.dt, time.monotonic() - t0))

    def _stopped(self) -> bool:
        return (
            self.simulation_stop_time is not None
            and self.scene.total_simulated_time >= self.simulation_stop_time
        )

    def _record(self, stats: FrameStats) -> FrameStats:
        self.frame_history.append(stats)
        return stats
