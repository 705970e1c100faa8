"""Headless application: scene loading, simulation loop, recording — the
analog of src/main.rs's Application/event loop for a card without a window
(the port of ``blub_tpu/app.py``, with the same subcommands and flags and one
more, ``--device``).

Usage:
  python -m blub_tpu_torch.app run scenes/column.json --sim-seconds 2 --record-fps 60
  python -m blub_tpu_torch.app screenshot scenes/dam_halfhalf.json --sim-seconds 0.5
  python -m blub_tpu_torch.app info scenes/wavegenerator.json
  python -m blub_tpu_torch.app run scenes/mini_dam.json --device cpu   # the plain versions

Everything that simulates or draws runs on ``--device`` (default ``cuda``,
which raises without CUDA): on the card each frame is one CUDA-graph launch
of the hand-written kernels that picks its substep count on the card, and
the renderer draws from the scene's device tensors.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build(args, graphs: bool = True):
    from .core.config import SimSettings, SolverConfig, load_scene
    from .runtime.scene import Scene

    settings = SimSettings(
        simulation_steps_per_second=args.steps_per_second,
        solver_velocity=SolverConfig(max_num_iterations=args.solver_iterations),
        solver_density=SolverConfig(max_num_iterations=args.solver_iterations),
    )
    return Scene(load_scene(args.scene), settings, capacity=args.capacity, device=args.device, graphs=graphs)


def _renderer(scene, args):
    from .render.camera import Camera
    from .render.renderer import FluidRenderingMode, RenderSettings, SceneRenderer, VolumeVisualizationMode

    spec = getattr(args, "camera", "")
    camera = Camera.parse(spec, scene.grid_dim_external) if spec else None
    cubemap_dir = getattr(args, "cubemap", "")
    if cubemap_dir:
        from .render.cubemap import load_cubemap
        from .render.environment import set_sky_cubemap

        set_sky_cubemap(load_cubemap(cubemap_dir))
    return SceneRenderer(
        scene.grid_dim_external,
        camera=camera,
        settings=RenderSettings(
            width=args.width,
            height=args.height,
            fluid_mode=FluidRenderingMode(args.fluid_mode),
            volume_mode=VolumeVisualizationMode(getattr(args, "volume_mode", "none")),
            grid_to_world_scale=scene.config.fluid.grid_to_world_scale,
            show_voxel_debug=bool(getattr(args, "voxel_debug", False)),
            show_bounds_box=not getattr(args, "no_bounds", False),
            show_solid_meshes=not getattr(args, "no_solids", False),
        ),
        device=scene.device,
    )


def _draw(scene, renderer):
    """One image of the scene's current state: the particles go to the
    renderer as the scene's device tensors (no particle array comes to the
    host); grid fields for the volume modes come as numpy."""
    field = None
    vector = False
    velocity_grid = None
    marker = None
    mode = renderer.settings.volume_mode.value
    if mode != "none":
        fields = scene.debug_fields()
        if mode == "velocity":
            velocity_grid = fields.get("velocity")
            marker = fields.get("marker")
        else:
            field = fields.get(mode)

    solid_meshes = None
    solid_occ = None
    solid_vel = None
    if scene.solid_objects and (
        renderer.settings.show_solid_meshes or renderer.settings.show_voxel_debug
    ):
        t = scene.total_simulated_time
        solid_meshes = [
            (o.mesh_at(t), o.mesh_faces, o.mesh_albedo, o.mesh_uv, o.mesh_texture)
            for o in scene.solid_objects
            if o.mesh_verts is not None
        ]
        if renderer.settings.show_voxel_debug:
            solids = scene.current_solids()
            if solids is not None:
                solid_occ = solids.occupancy.cpu().numpy()
                solid_vel = solids.velocity.cpu().numpy()
    positions, velocities = scene.particle_tensors()
    return renderer.draw(
        positions,
        velocities,
        field=field,
        field_is_vector=vector,
        solid_meshes=solid_meshes,
        solid_occupancy=solid_occ,
        solid_velocity=solid_vel,
        velocity_grid=velocity_grid,
        marker=marker,
    )


def cmd_info(args) -> int:
    from .core.config import load_scene

    cfg = load_scene(args.scene)
    print(
        json.dumps(
            {
                "name": cfg.name,
                "grid_dimension": cfg.fluid.grid_dimension,
                "max_num_particles": cfg.fluid.max_num_particles,
                "grid_to_world_scale": cfg.fluid.grid_to_world_scale,
                "gravity": cfg.gravity,
                "fluid_cubes": len(cfg.fluid.fluid_cubes),
                "static_objects": [o.model for o in cfg.static_objects],
            },
            indent=2,
        )
    )
    return 0


def _path_desc(scene) -> str:
    if scene.device.type == "cuda":
        return "hand-written CUDA kernels, one CUDA-graph launch per frame, n_sub picked on the card"
    return "plain PyTorch versions on the CPU"


def cmd_run(args) -> int:
    from .render.recorder import ScreenshotRecorder
    from .runtime.controller import SimulationController

    scene = _build(args)
    ctl = SimulationController(scene)
    print(
        f"scene {scene.config.name}: grid {scene.params.grid_dim}, "
        f"{scene.params.num_particles} particles, path: {_path_desc(scene)}",
        file=sys.stderr,
    )

    if args.resume:
        from .runtime.checkpoint import load_scene_checkpoint

        load_scene_checkpoint(scene, args.resume)
        print(f"resumed from {args.resume} at t={scene.total_simulated_time:.3f}s", file=sys.stderr)

    recorder = None
    renderer = None
    if args.record_fps:
        recorder = ScreenshotRecorder(args.output_dir)
        renderer = _renderer(scene, args)
        rec_dir = recorder.start_recording()
        print(f"recording to {rec_dir}", file=sys.stderr)

    frame_len = 1.0 / args.record_fps if args.record_fps else 0.25
    t_end = args.sim_seconds
    wall0 = time.time()
    last_autosave = time.time()
    while scene.total_simulated_time < t_end - 1e-9:
        if not ctl.fast_forward(min(frame_len, t_end - scene.total_simulated_time)).sim_steps:
            break  # less than half a step left: --sim-seconds is not a whole number of steps
        if recorder is not None:
            recorder.capture_frame(_draw(scene, renderer))
        if args.checkpoint_every > 0 and time.time() - last_autosave >= args.checkpoint_every:
            # periodic autosave, so a crash does not lose the whole run
            from .runtime.checkpoint import save_scene

            path = save_scene(scene, args.checkpoint_out or "autosave.npz")
            last_autosave = time.time()
            print(f"autosaved checkpoint: {path}", file=sys.stderr)
        stats = scene.solver_stats()
        print(
            f"t={scene.total_simulated_time:7.3f}s steps={ctl.total_steps:6d} "
            f"vel[{stats['velocity']['iterations']:2d}it {stats['velocity']['error']:.3f}] "
            f"den[{stats['density']['iterations']:2d}it {stats['density']['error']:.3f}] "
            f"lost={stats['lost_particles']}",
            file=sys.stderr,
        )
    wall = time.time() - wall0
    if args.checkpoint_out:
        from .runtime.checkpoint import save_scene

        path = save_scene(scene, args.checkpoint_out)
        print(f"checkpoint: {path}", file=sys.stderr)
    print(
        json.dumps(
            {
                "simulated_seconds": round(scene.total_simulated_time, 4),
                "steps": ctl.total_steps,
                "wall_seconds": round(wall, 2),
                "steps_per_second": round(ctl.total_steps / max(wall, 1e-9), 2),
                "particles": scene.params.num_particles,
                "layout": scene.layout,
                "lost_particles": scene.solver_stats()["lost_particles"],
            }
        )
    )
    return 0


def cmd_screenshot(args) -> int:
    from .render.recorder import ScreenshotRecorder
    from .runtime.controller import SimulationController

    scene = _build(args)
    ctl = SimulationController(scene)
    if args.sim_seconds > 0:
        ctl.fast_forward(args.sim_seconds)
    renderer = _renderer(scene, args)
    path = ScreenshotRecorder(args.output_dir).screenshot(_draw(scene, renderer))
    print(str(path))
    return 0


def cmd_watch(args) -> int:
    from .gui.dashboard import Dashboard
    from .render.recorder import ScreenshotRecorder
    from .runtime.controller import SimulationController

    scene = _build(args)
    ctl = SimulationController(scene)
    dash = Dashboard(ctl, renderer=_renderer(scene, args), recorder=ScreenshotRecorder(args.output_dir))
    dash.run(max_wall_seconds=args.max_wall_seconds)
    return 0


def cmd_profile(args) -> int:
    # per-phase device time needs eager frames: a graph replay has no phase
    # ranges (runtime/profiler.parse_phase_trace)
    scene = _build(args, graphs=not args.trace_phases)
    for _ in range(3):  # settle into a typical flow regime (and build the kernels)
        scene.step()

    if args.solver_history:
        # per-iteration PCG convergence on the current flow state: the analog
        # of the reference's per-iteration profiler scopes and
        # error/iteration plots (pressure_solver.rs:655-723, gui/mod.rs:177-210)
        for name, hist in solver_histories(scene):
            it = int(np.sum(np.isfinite(hist)))
            print(f"{name}: {it} iterations")
            for i in range(it):
                print(f"  it {i:2d}  max|r|*dt = {hist[i]:.3e}")
        return 0

    if args.trace_phases:
        # per-phase device time from a torch.profiler trace of one eager frame
        # (runtime/profiler.py)
        from .runtime.profiler import profile_trace

        phases = profile_trace(scene.step, log_dir=args.trace_out + ".trace")
        total = sum(phases.values())
        print(f"{'phase':<18}{'ms/frame':>10}  {'%':>5}   (device time, eager frame)")
        for k, v in phases.items():
            print(f"{k:<18}{v:10.3f}  {100 * v / max(total, 1e-9):5.1f}")
        print(f"{'total device':<18}{total:10.3f}")
        print(f"trace dir: {args.trace_out}.trace", file=sys.stderr)
        return 0

    from .runtime.profiler import profile_step

    means, timer = profile_step(scene.params, scene.state, solids=scene.current_solids())
    print(timer.report())
    path = timer.write_chrometrace(args.trace_out)
    print(f"chrometrace: {path}", file=sys.stderr)
    return 0


def solver_histories(scene):
    """(name, per-iteration error history) for a velocity and a density PCG
    solve on the scene's current state, through the production solver
    (``ops/pcg.solve_pressure`` with ``with_history=True``: on the card the
    history instantiation of the persistent kernel, on the CPU the plain
    version), as the JAX package's ``app._solver_histories`` does with its
    production solver. The label names the solver. The last finite entry of
    each history must equal the solve's stats error (asserted).
    Deviation, as in the JAX package: the density solve uses the pre-advect
    positions and the velocity solve's marker; it measures the real
    convergence on the live flow without running half a substep."""
    from .ops import p2g, pcg
    from .sim.dense_transfer import density_rhs_from_raw
    from .sim.divergence import compute_divergence_rhs
    from .sim.sm_phases import marker_from_counts

    params = scene.params
    dt = np.float32(params.dt)
    solver_name = "pcg_solve_kernel<true>" if scene.device.type == "cuda" else "solve_pressure_plain"
    solids = scene.current_solids()
    occupancy = solids.occupancy if solids is not None else None
    solid_vel = solids.velocity if solids is not None else None
    t = scene.state.table

    acc = p2g.p2g(t.posq, t.dyn)
    marker = marker_from_counts(acc[6], params.grid_dim, occupancy)
    vel = p2g.normalize_velocity(acc, marker, params.gravity_grid, dt)
    rhs = compute_divergence_rhs(vel, marker, solid_vel)
    res_v = pcg.solve_pressure(scene.state.pressure_vel, rhs, marker, params.solver_vel, dt, with_history=True)
    den_rhs = density_rhs_from_raw(p2g.p2g(t.posq, None, density=True)[0], marker, dt)
    res_d = pcg.solve_pressure(scene.state.pressure_den, den_rhs, marker, params.solver_den, dt, with_history=True)

    out = []
    for res in (res_v, res_d):
        h = res.history.cpu().numpy()
        it = int(res.stats.iterations)
        e = float(res.stats.error)
        # the history's last finite entry is the stats error: the history is
        # the production solver's own
        if it > 0 and not (np.isfinite(h[it - 1]) and abs(float(h[it - 1]) - e) <= 1e-6 * max(1.0, abs(e))):
            raise AssertionError(f"{solver_name}: history entry {it - 1} = {h[it - 1]} but stats error {e}")
        out.append(h)
    return [
        (f"velocity solve [{solver_name}]", out[0]),
        (f"density solve (pre-advect positions) [{solver_name}]", out[1]),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="blub_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("scene")
        sp.add_argument("--device", default="cuda",
                        help="torch device to simulate and render on (default cuda; cpu runs the plain versions)")
        sp.add_argument("--steps-per-second", type=int, default=120)
        sp.add_argument("--solver-iterations", type=int, default=32)
        sp.add_argument("--capacity", type=int, default=16)
        sp.add_argument("--sim-seconds", type=float, default=1.0)
        sp.add_argument("--width", type=int, default=640)
        sp.add_argument("--height", type=int, default=480)
        sp.add_argument("--fluid-mode", default="particles_velocity",
                        choices=["none", "screen_space_fluid", "particles_velocity", "particles_index"])
        sp.add_argument("--volume-mode", default="none",
                        choices=["none", "velocity", "divergence_error",
                                 "pressure_from_velocity", "pressure_from_density", "marker"])
        sp.add_argument("--voxel-debug", action="store_true",
                        help="draw the voxelized solids (VoxelRenderer debug view)")
        sp.add_argument("--no-bounds", action="store_true",
                        help="hide the domain bounds box")
        sp.add_argument("--no-solids", action="store_true",
                        help="hide solid object meshes")
        sp.add_argument("--cubemap", default="",
                        help="directory with px/nx/py/ny/pz/nz.hdr RGBE faces "
                        "for the sky (lfs-pointer/missing files fall back to "
                        "a procedural SH-baked cubemap)")
        sp.add_argument("--output-dir", default=".")
        sp.add_argument(
            "--camera", default="",
            help="viewpoint 'px,py,pz[:tx,ty,tz[:fov_deg]]' in grid units "
                 "(default: auto-framed; target defaults to domain center)",
        )

    sp = sub.add_parser("info", help="print scene facts")
    sp.add_argument("scene")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("run", help="simulate (optionally recording frames)")
    common(sp)
    sp.add_argument("--record-fps", type=float, default=0.0)
    sp.add_argument("--checkpoint-out", default="")
    sp.add_argument("--checkpoint-every", type=float, default=0.0,
                    help="autosave the checkpoint every N wall seconds (0 = off)")
    sp.add_argument("--resume", default="")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("screenshot", help="simulate then save one frame")
    common(sp)
    sp.set_defaults(fn=cmd_screenshot)

    sp = sub.add_parser("watch", help="interactive terminal dashboard")
    common(sp)
    sp.add_argument("--max-wall-seconds", type=float, default=None)
    sp.set_defaults(fn=cmd_watch)

    sp = sub.add_parser("profile", help="per-phase step timing + chrometrace")
    common(sp)
    sp.add_argument("--trace-out", default="simulation-trace.json")
    sp.add_argument(
        "--trace-phases", action="store_true",
        help="attribute device time per phase from a torch.profiler trace "
        "of one eager frame",
    )
    sp.add_argument(
        "--solver-history", action="store_true",
        help="print per-iteration PCG residuals for one velocity + one "
        "density solve on the current flow (the reference's per-iteration "
        "solver plots)",
    )
    sp.set_defaults(fn=cmd_profile)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
