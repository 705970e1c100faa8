"""Times the scene load's mesh bake on the card: ``ops/sdf.launch`` on the
bunny scene's bake (588,059 points x 400 triangles), and the cube,
``icosphere_mesh(5)`` and ``icosphere_mesh(6)`` at the same points. Prints
one JSON line: per bake its ms (CUDA events, host gaps included), its
device ms (back to back) and a digest of its output's bits; the card's name
and power limit; the file of the ``ops/sdf`` that ran.

    python3 -m blub_tpu_torch.probes.sdf_bakes

It calls only ``ops/sdf.launch(verts, tris, points)``, ``core/models``'
``solid_bakes``, ``cube_mesh`` and ``icosphere_mesh`` and the timing
helpers, so run as a file with another checkout first on ``PYTHONPATH`` it
times that checkout's bake the same way (two versions compared in one
process each, on one card):

    PYTHONPATH=OTHER python3 blub_tpu_torch/probes/sdf_bakes.py
"""

from __future__ import annotations

import hashlib
import json
import logging
import pathlib

import numpy as np
import torch

from blub_tpu_torch.core import models
from blub_tpu_torch.core.config import load_scene
from blub_tpu_torch.ops import sdf
from blub_tpu_torch.probes.timing import card_line, cuda_ms, device_ms, require_card

SCENE = pathlib.Path(__file__).resolve().parents[2] / "scenes" / "dam_halfhalf_staticbunny.json"


def digest(out: torch.Tensor) -> str:
    """The output's f32 bits, every NaN as one payload."""
    out = torch.where(torch.isnan(out), torch.full_like(out, float("nan")), out)
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> None:
    require_card("sdf_bakes")
    logging.disable(logging.WARNING)
    (bunny,) = models.solid_bakes(load_scene(SCENE))
    points = torch.from_numpy(np.ascontiguousarray(bunny.local)).cuda()
    meshes = {"bunny": (bunny.mesh_verts, bunny.mesh_faces), "cube": models.cube_mesh(),
              "icosphere_mesh(5)": models.icosphere_mesh(5), "icosphere_mesh(6)": models.icosphere_mesh(6)}
    res = {"card": card_line(), "sdf": sdf.__file__, "points": points.shape[0], "bakes": {}}
    for name, (v, f) in meshes.items():
        verts = torch.from_numpy(np.ascontiguousarray(v, np.float32)).cuda()
        tris = torch.from_numpy(np.ascontiguousarray(f, np.int32)).cuda()
        reps = 3 if tris.shape[0] > 10_000 else 10
        res["bakes"][name] = {"triangles": tris.shape[0], "bits": digest(sdf.launch(verts, tris, points)),
                              "ms": cuda_ms(lambda: sdf.launch(verts, tris, points), reps),
                              "device_ms": device_ms(lambda: sdf.launch(verts, tris, points), reps)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
