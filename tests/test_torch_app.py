"""The port's app entry point (``python -m blub_tpu_torch.app``) against the
JAX package's ``blub_tpu/app.py``, on the CPU (``--device cpu``: the plain
versions), on a 16x8x8 scene written to a temporary directory.

- ``info`` prints the JSON that JAX's prints, on a repository scene and the
  small one;
- ``run --device cpu`` for two frames, recording PNGs that decode;
  ``screenshot`` in screen-space-fluid mode;
- ``profile --solver-history`` against JAX's ``_solver_histories`` on the
  same state (the port's table and pressures handed to JAX): iterations
  exact, finite entries within rtol 1e-4, +inf at the same slots;
- the dashboard's ``render()`` and key handling, as tests/test_runtime.py
  drives JAX's (pause, resume, quit, solver and render-mode keys, a
  screenshot);
- without ``--device``, a subcommand that simulates raises on a machine
  without CUDA rather than run on the CPU.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blub_tpu import app as japp
from blub_tpu.core import config as jconfig
from blub_tpu.core.types import SimParams as JaxSimParams
from blub_tpu.sim import slot_major as jsm
from blub_tpu_torch import app, convert
from blub_tpu_torch.core.config import SimSettings, load_scene_dict
from blub_tpu_torch.gui.dashboard import Dashboard
from blub_tpu_torch.render.png import read_png
from blub_tpu_torch.render.recorder import ScreenshotRecorder
from blub_tpu_torch.render.renderer import RenderSettings, SceneRenderer
from blub_tpu_torch.runtime.controller import SimulationController
from blub_tpu_torch.runtime.scene import Scene

torch.set_num_threads(1)

G = (16, 8, 8)
SMALL = {
    "gravity": {"x": 0.0, "y": -9.81, "z": 0.0},
    "fluid": {
        "world_position": {"x": 0.0, "y": 0.0, "z": 0.0}, "grid_to_world_scale": 0.01,
        "grid_dimension": {"x": G[0], "y": G[1], "z": G[2]}, "max_num_particles": 100000,
        "fluid_cubes": [{"min": {"x": 0.01, "y": 0.01, "z": 0.01}, "max": {"x": 0.08, "y": 0.06, "z": 0.07}}],
    },
    "static_objects": [],
}
TWO_FRAMES = ["--sim-seconds", str(2.0 / 120.0)]
SMALL_IMAGE = ["--width", "160", "--height", "120"]


@pytest.fixture
def scene_file(tmp_path):
    path = tmp_path / "small.json"
    path.write_text(json.dumps(SMALL))
    return path


@pytest.mark.parametrize("which", ["wavegenerator", "small"])
def test_info_matches_jax(capsys, scene_file, which):
    path = str(scene_file) if which == "small" else "scenes/wavegenerator.json"
    assert app.main(["info", path]) == 0
    ours = capsys.readouterr().out
    assert japp.main(["info", path]) == 0
    assert ours == capsys.readouterr().out
    assert json.loads(ours)["grid_dimension"] == (list(G) if which == "small" else [128, 64, 64])


def test_run_records_frames(capsys, scene_file, tmp_path):
    out = tmp_path / "out"
    assert app.main(["run", str(scene_file), "--device", "cpu", "--record-fps", "120", "--output-dir", str(out),
                     *TWO_FRAMES, *SMALL_IMAGE]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 2 and res["lost_particles"] == 0 and res["layout"] == "sm"
    frames = sorted((out / "recording0").glob("*.png"))
    assert [p.name for p in frames] == ["000000.png", "000001.png"]
    imgs = [read_png(p) for p in frames]
    assert all(i is not None and i.shape == (120, 160, 3) for i in imgs)
    assert (imgs[0] != imgs[1]).any()  # the fluid moved


def test_screenshot(capsys, scene_file, tmp_path):
    assert app.main(["screenshot", str(scene_file), "--device", "cpu", "--fluid-mode", "screen_space_fluid",
                     "--output-dir", str(tmp_path), "--sim-seconds", "0", *SMALL_IMAGE]) == 0
    path = capsys.readouterr().out.strip()
    assert path.endswith("screenshot0.png")
    img = read_png(path)
    assert img is not None and img.shape == (120, 160, 3) and img.std() > 0


def _jax_stub(scene):
    """The port scene's state as the JAX app's ``_solver_histories`` reads
    a Scene: params, solids (none), the identity axis permutation and the
    state's table and pressures."""
    from blub_tpu.sim.axis_layout import IDENTITY

    t = convert.table_to_jax(scene.state.table)
    sm = jsm.SlotMajorTable(posq=jnp.asarray(t["posq"]), dyn=jnp.asarray(t["dyn"]), lost=jnp.asarray(t["lost"]),
                            grid_dim=G)
    params = JaxSimParams.from_scene(jconfig.load_scene_dict(SMALL, "small"), jconfig.SimSettings(),
                                     num_particles=scene.params.num_particles)
    state = types.SimpleNamespace(table=jax.jit(jsm.to_table)(sm),
                                  pressure_vel=jnp.asarray(scene.state.pressure_vel.numpy()),
                                  pressure_den=jnp.asarray(scene.state.pressure_den.numpy()))
    return types.SimpleNamespace(params=params, current_solids=lambda: None, perm=IDENTITY, state=state)


def test_solver_history_matches_jax(capsys, monkeypatch, scene_file):
    """``profile --solver-history`` prints the production solve's history
    (the plain version on the CPU); on the same state JAX's
    ``_solver_histories`` gives the same iterations and histories."""
    seen = {}
    histories = app.solver_histories

    def spy(scene):
        seen["scene"], seen["out"] = scene, histories(scene)
        return seen["out"]

    monkeypatch.setattr(app, "solver_histories", spy)
    assert app.main(["profile", str(scene_file), "--device", "cpu", "--solver-history"]) == 0
    text = capsys.readouterr().out
    ours = seen["out"]
    theirs = japp._solver_histories(_jax_stub(seen["scene"]))
    assert [n.split(" [")[0] for n, _ in ours] == [n.split(" [")[0] for n, _ in theirs]
    for (name, a), (_, b) in zip(ours, theirs):
        its = int(np.isfinite(a).sum())
        assert f"{name}: {its} iterations" in text
        assert its >= 1 and np.isfinite(b).sum() == its
        np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
        np.testing.assert_allclose(a[:its], b[:its], rtol=1e-4)


def test_dashboard_renders_and_handles_keys(tmp_path):
    scene = Scene(load_scene_dict(SMALL, "small"), SimSettings(), device="cpu")
    ctl = SimulationController(scene)
    rend = SceneRenderer(scene.grid_dim_external, RenderSettings(width=64, height=48), device="cpu")
    dash = Dashboard(ctl, renderer=rend, recorder=ScreenshotRecorder(tmp_path))
    ctl.frame_steps()
    dash.collect()
    text = dash.render()
    assert "pressure solver" in text and "small" in text and "particles_velocity" in text
    assert dash.handle_key(" ") is True  # pause
    assert ctl.status.value == "paused"
    assert dash.handle_key(" ") is True  # resume
    assert dash.handle_key("m") is True and rend.settings.fluid_mode.value == "particles_index"
    assert dash.handle_key("I") is True and scene.settings.solver_velocity.max_num_iterations == 40
    assert dash.handle_key("s") is True and (tmp_path / "screenshot0.png").exists()
    assert dash.handle_key("h") is True and "camera at" in dash.render()
    assert dash.handle_key("q") is False


@pytest.mark.parametrize("cmd", ["run", "screenshot", "profile"])
def test_simulating_without_device_raises_without_cuda(scene_file, cmd):
    if torch.cuda.is_available():
        pytest.skip("the rule's raise needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.main([cmd, str(scene_file), *TWO_FRAMES])


def test_flags_match_jax():
    """Every subcommand and flag of the JAX app, and --device beside them."""
    import argparse

    def flags(main):
        seen = {}

        def grab(self, args=None, namespace=None):
            for action in self._subparsers._group_actions:
                for name, sp in action.choices.items():
                    seen[name] = sorted(o for a in sp._actions for o in a.option_strings)
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    ours, theirs = flags(app.main), flags(japp.main)
    assert sorted(ours) == sorted(theirs) == ["info", "profile", "run", "screenshot", "watch"]
    for cmd in theirs:
        extra = ["--device"] if cmd != "info" else []
        assert ours[cmd] == sorted(theirs[cmd] + extra), cmd

