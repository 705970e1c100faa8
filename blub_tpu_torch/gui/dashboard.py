"""Terminal dashboard — the headless analog of the reference's egui GUI
(src/gui/mod.rs), copied from ``blub_tpu/gui/dashboard.py`` to drive the
port's Scene and controller: frame-time and solver error/iteration bar charts, simulation
controls (pause/resume, fast-forward, reset, steps/s), scene facts, particle
counts. Renders with ANSI redraw; keys are read raw (termios) when stdin is a
TTY, otherwise it runs as a non-interactive status monitor.

Keys: [space] pause/resume   [f] fast-forward 1s   [r] reset
      [n]/[p] next/previous scene (scans scenes/)  [s] screenshot   [q] quit
      [t]/[T] solver tolerance /2,*2   [i]/[I] solver max iterations -8,+8
      [c]/[C] error check frequency    [m] fluid render mode   [v] volume mode
(the solver/timing knobs mirror the reference GUI, src/gui/mod.rs:212-420)
"""

from __future__ import annotations

import select
import sys
import time
from collections import deque
from dataclasses import replace as dataclasses_replace
from typing import Deque, Optional

from ..runtime.controller import SimulationController

BAR = " ▁▂▃▄▅▆▇█"


def _spark(values, width: int = 40, lo=None, hi=None) -> str:
    vals = list(values)[-width:]
    if not vals:
        return ""
    lo = min(vals) if lo is None else lo
    hi = max(vals) if hi is None else hi
    span = max(hi - lo, 1e-12)
    return "".join(BAR[min(int((v - lo) / span * (len(BAR) - 1)), len(BAR) - 1)] for v in vals)


class Dashboard:
    def __init__(self, controller: SimulationController, renderer=None, recorder=None):
        self.ctl = controller
        self.renderer = renderer
        self.recorder = recorder
        self.err_vel: Deque[float] = deque(maxlen=100)
        self.err_den: Deque[float] = deque(maxlen=100)
        self.iters_vel: Deque[int] = deque(maxlen=100)
        self.iters_den: Deque[int] = deque(maxlen=100)
        self.frame_ms: Deque[float] = deque(maxlen=100)
        self._msg = ""

    # ---------------------------------------------------------------- frame

    def collect(self) -> None:
        # non-blocking: never stalls the step pipeline (<=1 frame stale)
        stats = self.ctl.scene.solver_stats(block=False)
        self.err_vel.append(stats["velocity"]["error"])
        self.err_den.append(stats["density"]["error"])
        self.iters_vel.append(stats["velocity"]["iterations"])
        self.iters_den.append(stats["density"]["iterations"])
        if self.ctl.frame_history:
            self.frame_ms.append(self.ctl.frame_history[-1].wall_seconds * 1000.0)

    def render(self) -> str:
        scene = self.ctl.scene
        cfg = scene.config
        stats = scene.solver_stats(block=False)
        status = self.ctl.status.value
        lines = [
            f"\x1b[1mblub-tpu\x1b[0m  scene \x1b[36m{cfg.name}\x1b[0m   grid {cfg.fluid.grid_dimension}   "
            f"{scene.params.num_particles:,} particles   [{status}]",
            "",
            f"  sim time   {scene.total_simulated_time:9.3f} s    steps {self.ctl.total_steps:8d}    "
            f"steps/s setting {scene.settings.simulation_steps_per_second}",
            f"  frame ms   {_spark(self.frame_ms)}  {self.frame_ms[-1] if self.frame_ms else 0:7.1f} ms",
            "",
            f"  \x1b[1mpressure solver (velocity)\x1b[0m   error {stats['velocity']['error']:8.4f}   "
            f"iterations {stats['velocity']['iterations']:3d}",
            f"    error   {_spark(self.err_vel, lo=0.0)}",
            f"    iters   {_spark(self.iters_vel, lo=0, hi=max(self.ctl.scene.settings.solver_velocity.max_num_iterations, 1))}",
            f"  \x1b[1mpressure solver (density)\x1b[0m    error {stats['density']['error']:8.4f}   "
            f"iterations {stats['density']['iterations']:3d}",
            f"    error   {_spark(self.err_den, lo=0.0)}",
            f"    iters   {_spark(self.iters_den, lo=0, hi=max(self.ctl.scene.settings.solver_density.max_num_iterations, 1))}",
            "",
            f"  lost particles {stats['lost_particles']}",
            "",
            f"  solver: tol {scene.settings.solver_velocity.error_tolerance:g}  "
            f"max-it {scene.settings.solver_velocity.max_num_iterations}  "
            f"check-freq {scene.settings.solver_velocity.error_check_frequency}"
            + (
                f"   render: {self.renderer.settings.fluid_mode.value}"
                f" / {self.renderer.settings.volume_mode.value}"
                if self.renderer is not None
                else ""
            ),
            "",
            "  [space] pause  [f] +1s  [r] reset  [s] screenshot  [n/p] next/prev scene  [q] quit",
            "  [t/T] tolerance  [i/I] max iters  [c/C] check freq  [m] fluid mode  [v] volume mode  [</>] time scale",
            "  camera: [h/l] orbit  [j/k] tilt  [z/x] dolly  [w/a/d/e] fly  [0] reframe",
        ]
        if self._msg:
            lines.append(f"  \x1b[33m{self._msg}\x1b[0m")
        return "\n".join(lines)

    # ----------------------------------------------------------------- keys

    def handle_key(self, key: str) -> bool:
        """Returns False when the dashboard should quit."""
        if key == "q":
            return False
        if key == " ":
            self.ctl.pause_or_resume()
        elif key == "f":
            self._msg = "fast-forwarding 1 s..."
            self.ctl.fast_forward(1.0)
            self._msg = "fast-forwarded 1 s"
        elif key == "r":
            self.ctl.restart()
            self._msg = "scene reset"
        elif key == "+":
            self._set_rate(self.ctl.scene.settings.simulation_steps_per_second * 2)
        elif key == "-":
            self._set_rate(max(self.ctl.scene.settings.simulation_steps_per_second // 2, 20))
        elif key == "s" and self.renderer is not None and self.recorder is not None:
            scene = self.ctl.scene
            rgb = self.renderer.draw(*scene.particle_tensors())
            path = self.recorder.screenshot(rgb)
            self._msg = f"wrote {path}"
        elif key in "tT":
            self._tweak_solvers(
                lambda c: dataclasses_replace(
                    c, error_tolerance=c.error_tolerance * (2.0 if key == "T" else 0.5)
                )
            )
        elif key in "iI":
            self._tweak_solvers(
                lambda c: dataclasses_replace(
                    c,
                    max_num_iterations=max(
                        c.max_num_iterations + (8 if key == "I" else -8), 4
                    ),
                )
            )
        elif key in "cC":
            self._tweak_solvers(
                lambda c: dataclasses_replace(
                    c,
                    error_check_frequency=max(
                        c.error_check_frequency + (1 if key == "C" else -1), 1
                    ),
                )
            )
        elif key == "m" and self.renderer is not None:
            self._cycle_mode("fluid_mode")
        elif key == "v" and self.renderer is not None:
            self._cycle_mode("volume_mode")
        elif key in "<>":
            self.ctl.time_scale = max(
                self.ctl.time_scale * (2.0 if key == ">" else 0.5), 1.0 / 64.0
            )
            self._msg = f"time scale -> {self.ctl.time_scale:g}x"
        elif key in "np":
            self._next_scene(-1 if key == "p" else 1)
        elif key in "hljkzx0wade" and self.renderer is not None:
            self._camera_key(key)
        return True

    def _camera_key(self, key: str) -> None:
        """Terminal fly/orbit camera (the reference's WASD+mouse camera,
        src/camera.rs:104-165, mapped to keys; next [s] screenshot or render
        uses the new viewpoint)."""
        cam = self.renderer.camera
        step = max(self.ctl.scene.grid_dim_external) * 0.05
        if key == "h":
            cam.orbit(-15.0, 0.0)
        elif key == "l":
            cam.orbit(15.0, 0.0)
        elif key == "j":
            cam.orbit(0.0, -10.0)
        elif key == "k":
            cam.orbit(0.0, 10.0)
        elif key == "z":
            cam.dolly(0.8)
        elif key == "x":
            cam.dolly(1.25)
        elif key == "w":
            cam.fly(forward=step)
        elif key == "e":
            cam.fly(forward=-step)
        elif key == "a":
            cam.fly(right=-step)
        elif key == "d":
            cam.fly(right=step)
        elif key == "0":
            from ..render.camera import Camera

            self.renderer.camera = Camera.framing(self.ctl.scene.grid_dim_external)
        p = cam.position if key != "0" else self.renderer.camera.position
        self._msg = f"camera at ({p[0]:.0f}, {p[1]:.0f}, {p[2]:.0f})"

    def _next_scene(self, step: int = 1) -> None:
        """Cycle to the next/previous scene JSON (the reference GUI's scene
        selector scans the scenes/ folder, gui/mod.rs:24-34, 212-247)."""
        from ..core.config import list_scenes
        from ..runtime.scene import Scene

        scenes = list_scenes()
        if not scenes:
            self._msg = "no scenes found"
            return
        cur = self.ctl.scene.config.name
        names = [p.stem for p in scenes]
        nxt = (
            scenes[(names.index(cur) + step) % len(scenes)]
            if cur in names
            else scenes[0]
        )
        old = self.ctl.scene
        self.ctl.scene = Scene(nxt, settings=old.settings, capacity=old.capacity, device=old.device)
        self.ctl.restart()
        if self.renderer is not None:
            from ..render.camera import Camera

            self.renderer.grid_dim = self.ctl.scene.grid_dim_external
            self.renderer.camera = Camera.framing(self.renderer.grid_dim)
            self.renderer.settings.grid_to_world_scale = (
                self.ctl.scene.config.fluid.grid_to_world_scale
            )
        self._msg = f"scene -> {self.ctl.scene.config.name} (compiles on first step)"

    def _cycle_mode(self, attr: str) -> None:
        s = self.renderer.settings
        cur = getattr(s, attr)
        options = list(type(cur))
        nxt = options[(options.index(cur) + 1) % len(options)]
        setattr(s, attr, nxt)
        self._msg = f"{attr} -> {nxt.value}"

    def _tweak_solvers(self, fn) -> None:
        scene = self.ctl.scene
        st = scene.settings
        new = dataclasses_replace(
            st, solver_velocity=fn(st.solver_velocity), solver_density=fn(st.solver_density)
        )
        scene.update_settings(new)
        self._msg = (
            f"solver: tol {new.solver_velocity.error_tolerance:g}, "
            f"max-it {new.solver_velocity.max_num_iterations}, "
            f"check-freq {new.solver_velocity.error_check_frequency} (recompiles)"
        )

    def _set_rate(self, rate: int) -> None:
        scene = self.ctl.scene
        scene.update_settings(
            dataclasses_replace(scene.settings, simulation_steps_per_second=rate)
        )
        self._msg = f"steps/s -> {rate}"

    # ----------------------------------------------------------------- loop

    def run(self, max_wall_seconds: Optional[float] = None, fps: float = 10.0) -> None:
        interactive = sys.stdin.isatty()
        ctx = _RawTerminal() if interactive else _NullCtx()
        t_end = time.monotonic() + max_wall_seconds if max_wall_seconds else None
        with ctx:
            while True:
                self.ctl.frame_steps()
                self.collect()
                sys.stdout.write("\x1b[2J\x1b[H" + self.render() + "\n")
                sys.stdout.flush()
                if interactive:
                    r, _, _ = select.select([sys.stdin], [], [], 1.0 / fps)
                    if r:
                        key = sys.stdin.read(1)
                        if not self.handle_key(key):
                            break
                else:
                    time.sleep(1.0 / fps)
                if t_end is not None and time.monotonic() > t_end:
                    break


class _RawTerminal:
    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass
