"""Solid scene models: OBJ loading, signed-distance baking, rigid animation
(copy of ``blub_tpu/core/models.py``; everything but the bake on the host).

Each object's signed distance field is baked once, at load, over the fluid
grid extended by the animation's translation range; every substep resamples
it at the animated pose (``sim/voxelize.py``). Animation semantics follow
the reference (src/scene/models.rs):

- ping-pong translation between world_position and target over 2*duration,
  Linear or SmoothStep curve (models.rs:154-171);
- constant-rate rotation on top of the static Euler rotation
  (models.rs:174-181);
- solid velocity = finite-difference translation velocity / grid scale plus
  omega x r (models.rs:187-193, voxelize/conservative_hull.frag:17-23).

``mesh_sdf`` bakes a mesh's signed distance on ``device``: the card's kernel
(``ops/csrc/sdf.cu``) unless the caller asks for the CPU, where the plain
PyTorch version runs (the JAX package bakes with numpy or its g++ helper;
the plain version gives its numpy bits). ``box_sdf`` stays on the host. Diffuse
textures decode from PNG (``render/png.py``) or binary PPM; any other image
gives the material's checker, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import pathlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import sdf
from .config import SceneConfig, StaticObjectConfig, smoothstep
from .device import resolve_device

log = logging.getLogger(__name__)


def default_models_dir() -> pathlib.Path:
    """The repository's ``models/`` directory."""
    return pathlib.Path(__file__).resolve().parents[2] / "models"


# ---------------------------------------------------------------------------
# OBJ loading


def load_obj(path: pathlib.Path) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Minimal OBJ parser (v / f lines, fan-triangulated). Returns
    (verts f32[V,3], tris i32[T,3]) or None if the file is unusable (e.g. a
    git-lfs pointer)."""
    full = load_obj_materials(path)
    if full is None:
        return None
    return full[0], full[1]


def load_obj_materials(path: pathlib.Path):
    """OBJ parser with per-material splits (models.rs:184-224). Returns
    (verts f32[V,3], tris i32[T,3], face_albedo f32[T,3] | None, face_uv
    f32[T,3,2] | None, texture f32[H,W,3] | None), or None."""
    try:
        text = path.read_text(errors="ignore")
    except OSError:
        return None
    if text.startswith("version https://git-lfs"):
        return None
    materials: dict = {}
    verts: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    tris: List[Tuple[int, int, int]] = []
    tri_uv: List[Tuple[int, int, int]] = []  # vt indices per corner, -1 = none
    tri_mtl: List[Optional[str]] = []
    current = None
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v" and len(parts) >= 4:
            verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif parts[0] == "vt" and len(parts) >= 3:
            uvs.append((float(parts[1]), float(parts[2])))
        elif parts[0] == "f" and len(parts) >= 4:
            idx, uvi = [], []
            for p in parts[1:]:
                sub = p.split("/")
                i = int(sub[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
                if len(sub) > 1 and sub[1]:
                    t = int(sub[1])
                    uvi.append(t - 1 if t > 0 else len(uvs) + t)
                else:
                    uvi.append(-1)
            for k in range(1, len(idx) - 1):
                tris.append((idx[0], idx[k], idx[k + 1]))
                tri_uv.append((uvi[0], uvi[k], uvi[k + 1]))
                tri_mtl.append(current)
        elif parts[0] == "usemtl" and len(parts) >= 2:
            current = parts[1]
        elif parts[0] == "mtllib" and len(parts) >= 2:
            materials.update(_load_mtl(path.parent / parts[1]))
    if not verts or not tris:
        return None
    albedo = None
    if materials and any(m in materials for m in tri_mtl):
        albedo = np.asarray([materials.get(m, {}).get("kd", (1.0, 1.0, 1.0)) for m in tri_mtl], np.float32)
    face_uv = None
    if uvs and any(c >= 0 for t in tri_uv for c in t):
        uv_arr = np.asarray(uvs, np.float32)
        face_uv = np.zeros((len(tris), 3, 2), np.float32)
        for f, corners in enumerate(tri_uv):
            for c, t in enumerate(corners):
                if 0 <= t < len(uv_arr):
                    face_uv[f, c] = uv_arr[t]
    texture = None
    for m in tri_mtl:
        mat = materials.get(m) if m else None
        if mat and mat.get("map_kd"):
            texture = _load_texture(path.parent / mat["map_kd"], mat.get("kd"))
            break
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32), albedo, face_uv, texture


def _load_mtl(path: pathlib.Path) -> dict:
    """name -> {kd: (r,g,b), map_kd: str|None} from a .mtl file (missing
    file -> {})."""
    try:
        text = path.read_text(errors="ignore")
    except OSError:
        return {}
    out, current = {}, None
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "newmtl" and len(parts) >= 2:
            current = parts[1]
            out[current] = {"kd": (1.0, 1.0, 1.0), "map_kd": None}
        elif parts[0] == "Kd" and current and len(parts) >= 4:
            out[current]["kd"] = (float(parts[1]), float(parts[2]), float(parts[3]))
        elif parts[0] == "map_Kd" and current and len(parts) >= 2:
            out[current]["map_kd"] = parts[-1]
    return out


def checker_texture(kd=(1.0, 1.0, 1.0), size: int = 8) -> np.ndarray:
    """Procedural UV checker: the material's Kd alternating with its darker
    half."""
    kd = np.asarray(kd if kd is not None else (1.0, 1.0, 1.0), np.float32)
    img = np.empty((size, size, 3), np.float32)
    parity = (np.indices((size, size)).sum(axis=0) % 2).astype(bool)
    img[~parity] = kd
    img[parity] = kd * 0.45
    return img


def _load_texture(path: pathlib.Path, kd) -> np.ndarray:
    """Diffuse texture: a PNG (``render/png.decode_png``; the alpha channel,
    if any, is dropped) or a binary PPM (P6) if readable, else a Kd
    checker."""
    try:
        data = path.read_bytes()
        if data[:8] == b"\x89PNG\r\n\x1a\n":
            from ..render.png import decode_png

            img = decode_png(data)
            if img is not None:
                return (img[..., :3].astype(np.float32) / 255.0).clip(0, 1)
        if data[:2] == b"P6":
            fields = data.split(maxsplit=4)
            w, h, maxv = int(fields[1]), int(fields[2]), int(fields[3])
            pix = np.frombuffer(fields[4][: w * h * 3], np.uint8)
            if pix.size == w * h * 3:
                return (pix.reshape(h, w, 3).astype(np.float32) / maxv).clip(0, 1)
    except (OSError, ValueError, IndexError):
        pass
    return checker_texture(kd)


# ---------------------------------------------------------------------------
# Signed distance fields


def mesh_sdf(verts: np.ndarray, tris: np.ndarray, points: np.ndarray, device="cuda") -> np.ndarray:
    """Signed distance f32[N] from ``points`` f32[N,3] to a triangle mesh,
    sign by +x ray-crossing parity (``ops/sdf.mesh_sdf``: the kernel on the
    card, the plain PyTorch version with ``device="cpu"``). O(N*T), once per
    scene load; the points are uploaded once and the field comes back to the
    host."""
    dev = resolve_device(device)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return sdf.mesh_sdf(up(verts, np.float32), up(tris, np.int32), up(points, np.float32)).cpu().numpy()


def box_sdf(points: np.ndarray, lo, hi) -> np.ndarray:
    """Analytic axis-aligned box SDF (procedural stand-in geometry)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    center = (lo + hi) / 2
    half = (hi - lo) / 2
    q = np.abs(points - center) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(q.max(axis=-1), 0.0)
    return (outside + inside).astype(np.float32)


# ---------------------------------------------------------------------------
# Meshes (copies of blub_tpu/render/mesh.py::cube_mesh, icosphere_mesh)


def cube_mesh() -> Tuple[np.ndarray, np.ndarray]:
    """Unit cube [0,1]^3, 12 CCW (outward) triangles."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    f = np.array(
        [
            [0, 2, 6], [0, 6, 4],  # z-
            [1, 5, 7], [1, 7, 3],  # z+
            [0, 4, 5], [0, 5, 1],  # y-
            [2, 3, 7], [2, 7, 6],  # y+
            [0, 1, 3], [0, 3, 2],  # x-
            [4, 6, 7], [4, 7, 5],  # x+
        ],
        np.int32,
    )
    return v, f


def icosphere_mesh(subdiv: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Unit-diameter sphere centered at (0.5, 0.5, 0.5)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(p) for p in v]
    cache = {}

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
            m /= np.linalg.norm(m)
            verts.append(tuple(m))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for (a, b, c) in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    vv = np.asarray(verts, np.float32) * 0.5 + 0.5
    return vv, np.asarray(f, np.int32)


# ---------------------------------------------------------------------------
# Animated solid objects


@dataclasses.dataclass
class SolidObject:
    """One animated solid: a domain-aligned baked SDF + rigid motion params.

    ``sdf`` is baked in voxel units on a grid covering the fluid domain
    extended by the translation range: sdf[i,j,k] = signed distance (in cells)
    at voxel center (i - pad_lo) + 0.5, for the object at its reference pose
    (t=0 translation, static rotation)."""

    config: StaticObjectConfig
    sdf: np.ndarray  # f32[X+padx, Y+pady, Z+padz]
    pad_lo: Tuple[int, int, int]
    grid_scale: float
    fluid_world_position: Tuple[float, float, float]
    # render geometry in model-local space (the OBJ, or the procedural
    # stand-in that matches the baked SDF); None when there is none
    mesh_verts: Optional[np.ndarray] = None  # f32[N,3]
    mesh_faces: Optional[np.ndarray] = None  # i32[M,3]
    mesh_albedo: Optional[np.ndarray] = None  # f32[M,3] per-face Kd, or None
    mesh_uv: Optional[np.ndarray] = None  # f32[M,3,2] per-corner OBJ vt, or None
    mesh_texture: Optional[np.ndarray] = None  # f32[H,W,3] diffuse map, or None
    # set when the model asset was unusable and a procedural stand-in with a
    # comparable silhouette was substituted
    standin: Optional[str] = None

    def mesh_at(self, t: float) -> Optional[np.ndarray]:
        """Mesh vertices at animation time t, in grid space."""
        if self.mesh_verts is None:
            return None
        rot = self.rotation_at(t)
        world = self.world_position_at(t) + self.config.scale * (self.mesh_verts.astype(np.float64) @ rot.T)
        return ((world - np.asarray(self.fluid_world_position)) / self.grid_scale).astype(np.float32)

    def world_position_at(self, t: float) -> np.ndarray:
        cfg = self.config
        base = np.asarray(cfg.world_position, np.float64)
        anim = cfg.animation.translation if cfg.animation else None
        if anim is None:
            return base
        progress = math.fmod(t, anim.duration * 2.0)
        if progress > anim.duration:
            progress = anim.duration * 2.0 - progress
        progress = min(max(progress / anim.duration, 0.0), 1.0)
        if anim.curve == "SmoothStep":
            progress = smoothstep(progress)
        return base * (1.0 - progress) + np.asarray(anim.target, np.float64) * progress

    def voxel_shift_at(self, t: float) -> np.ndarray:
        """Translation since the reference pose, in voxel units."""
        return (self.world_position_at(t) - np.asarray(self.config.world_position)) / self.grid_scale

    @property
    def has_runtime_rotation(self) -> bool:
        rot = self.config.animation.rotation if self.config.animation else None
        return rot is not None and abs(rot.deg_per_sec) > 1e-12

    def rotation_at(self, t: float) -> np.ndarray:
        """R_total(t) = R_static * AxisAngle(omega * t) (models.rs:172-181)."""
        r_static = _euler_matrix(self.config.rotation_angles)
        rot = self.config.animation.rotation if self.config.animation else None
        if rot is None:
            return r_static
        axis = np.asarray(rot.axis, np.float64)
        axis = axis / max(np.linalg.norm(axis), 1e-9)
        return r_static @ _axis_angle_matrix(axis, math.radians(rot.deg_per_sec) * t)

    def resample_rotation_at(self, t: float) -> np.ndarray:
        """Q(t) = R_static * R_anim(t)^-1 * R_static^-1: maps (v - origin_v(t))
        in fluid voxel space to the reference-pose offset for reading the
        baked SDF (sim/voxelize.py::resample_sdf_rotated)."""
        r_static = _euler_matrix(self.config.rotation_angles)
        rot = self.config.animation.rotation if self.config.animation else None
        if rot is None:
            return np.eye(3)
        axis = np.asarray(rot.axis, np.float64)
        axis = axis / max(np.linalg.norm(axis), 1e-9)
        r_anim = _axis_angle_matrix(axis, math.radians(rot.deg_per_sec) * t)
        return r_static @ r_anim.T @ r_static.T

    def origin_voxel_at(self, t: float) -> np.ndarray:
        """Model origin (the rotation pivot) in fluid voxel coordinates."""
        return (self.world_position_at(t) - np.asarray(self.fluid_world_position)) / self.grid_scale

    def velocity_params_at(self, t: float, dt: float):
        """(v_trans_voxel f32[3], omega f32[3] rad/s, center_voxel f32[3]):
        finite-difference translation velocity (models.rs:187-193), zero
        while t <= dt; f64 on the host, then f32."""
        if t > dt:
            v = (self.world_position_at(t) - self.world_position_at(t - dt)) / dt
        else:
            v = np.zeros(3)
        v_voxel = v / self.grid_scale
        rot = self.config.animation.rotation if self.config.animation else None
        if rot is not None:
            axis = np.asarray(rot.axis, np.float64)
            axis = axis / max(np.linalg.norm(axis), 1e-9)
            omega = axis * math.radians(rot.deg_per_sec)
        else:
            omega = np.zeros(3)
        center_voxel = (self.world_position_at(t) - np.asarray(self.fluid_world_position)) / self.grid_scale
        return v_voxel.astype(np.float32), omega.astype(np.float32), center_voxel.astype(np.float32)


def _axis_angle_matrix(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Rodrigues rotation matrix for a unit axis."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    x, y, z = axis
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float64)
    return np.eye(3) + s * k + (1 - c) * (k @ k)


def _euler_matrix(angles_deg) -> np.ndarray:
    """Rotation matrix from Euler angles in degrees, XYZ order (cgmath
    Euler<Deg>: R = Rx * Ry * Rz applied to column vectors)."""
    ax, ay, az = (math.radians(a) for a in angles_deg)

    def rx(a):
        return np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])

    def ry(a):
        return np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])

    def rz(a):
        return np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])

    return rx(ax) @ ry(ay) @ rz(az)


@dataclasses.dataclass
class Bake:
    """One static object's bake, before it runs: the grid (``shape``, with
    ``pad_lo``), its voxel centres in model-local space (``local`` f32[N,3],
    f64 on the host, then f32) and the geometry baked against them."""

    config: StaticObjectConfig
    shape: np.ndarray  # int[3]
    pad_lo: np.ndarray  # int[3]
    local: np.ndarray  # f32[prod(shape), 3]
    mesh_verts: np.ndarray
    mesh_faces: np.ndarray
    mesh_albedo: Optional[np.ndarray] = None
    mesh_uv: Optional[np.ndarray] = None
    mesh_texture: Optional[np.ndarray] = None
    standin: Optional[str] = None
    box: bool = False  # a cube model without its OBJ: the analytic box SDF on the host


def solid_bakes(scene: SceneConfig, models_dir: pathlib.Path | None = None) -> List[Bake]:
    """What ``build_solid_objects`` bakes, object by object."""
    models = pathlib.Path(models_dir) if models_dir is not None else default_models_dir()
    dim = np.asarray(scene.fluid.grid_dimension)
    s_g = scene.fluid.grid_to_world_scale
    out = []
    for cfg in scene.static_objects:
        # translation range in voxels -> padding
        tmp = SolidObject(cfg, np.zeros(1, np.float32), (0, 0, 0), s_g, scene.fluid.world_position)
        shifts = [tmp.voxel_shift_at(t) for t in np.linspace(0, _anim_period(cfg), 64)]
        min_shift = np.floor(np.min(shifts, axis=0)).astype(int)
        max_shift = np.ceil(np.max(shifts, axis=0)).astype(int)
        # resample reads baked index i + pad_lo - shift for i in [0, dim):
        # pad_lo covers the largest positive shift, pad_hi the most negative
        pad_lo = np.maximum(max_shift, 0) + 1
        pad_hi = np.maximum(-min_shift, 0) + 2
        shape = dim + pad_lo + pad_hi

        # voxel centers in world space at the reference pose
        ii = np.indices(shape).reshape(3, -1).T.astype(np.float64)
        vox = ii - pad_lo + 0.5
        world = vox * s_g + np.asarray(scene.fluid.world_position)

        # model local space: world = T(world_pos) S(scale) R local
        rot = _euler_matrix(cfg.rotation_angles)
        local = ((world - np.asarray(cfg.world_position)) / cfg.scale) @ rot  # R^-1 = R^T
        local = local.astype(np.float32)

        geom = load_obj_materials(models / cfg.model)
        if geom is not None:
            out.append(Bake(cfg, shape, pad_lo, local, *geom))
            continue
        name = str(cfg.model).lower()
        if "cube" in name:
            out.append(Bake(cfg, shape, pad_lo, local, *cube_mesh(), box=True))
            continue
        # procedural stand-in with a comparable silhouette, baked through the
        # same mesh_sdf so physics and rendering agree
        if "bunny" in name:
            mesh, standin = procedural_bunny(), "bunny"
        elif "wgpu" in name or "logo" in name:
            mesh, standin = procedural_logo(), "logo"
        else:
            mesh, standin = icosphere_mesh(2), "sphere"
        log.warning(
            "model %s unavailable (git-lfs pointer?); substituting the procedural '%s' "
            "stand-in: this scene's physics differs from the reference's real mesh",
            cfg.model, standin,
        )
        out.append(Bake(cfg, shape, pad_lo, local, *mesh, standin=standin))
    return out


def build_solid_objects(
    scene: SceneConfig, models_dir: pathlib.Path | None = None, device="cuda"
) -> List[SolidObject]:
    """Load and bake every static object of a scene (``models_dir`` defaults
    to the repository's ``models/``). Mesh bakes run on ``device``: the card
    unless the caller asks for the CPU."""
    dev = resolve_device(device)
    s_g = scene.fluid.grid_to_world_scale
    out = []
    for b in solid_bakes(scene, models_dir):
        if b.box:
            sdf_local = box_sdf(b.local, (0, 0, 0), (1, 1, 1))
        else:
            sdf_local = mesh_sdf(b.mesh_verts, b.mesh_faces, b.local, dev)
        # local-space distance -> voxel units (uniform scale)
        field = (sdf_local * (b.config.scale / s_g)).reshape(b.shape).astype(np.float32)
        out.append(
            SolidObject(
                config=b.config,
                sdf=field,
                pad_lo=tuple(int(v) for v in b.pad_lo),
                grid_scale=s_g,
                fluid_world_position=scene.fluid.world_position,
                mesh_verts=np.asarray(b.mesh_verts, np.float32),
                mesh_faces=np.asarray(b.mesh_faces, np.int32),
                mesh_albedo=b.mesh_albedo,
                mesh_uv=b.mesh_uv,
                mesh_texture=b.mesh_texture,
                standin=b.standin,
            )
        )
    return out


def _placed(mesh, scale, center) -> Tuple[np.ndarray, np.ndarray]:
    v, f = mesh
    return (np.asarray(v, np.float64) - 0.5) * np.asarray(scale) + np.asarray(center), f


def _union(parts) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces, base = [], [], 0
    for v, f in parts:
        verts.append(np.asarray(v, np.float32))
        faces.append(np.asarray(f, np.int32) + base)
        base += len(v)
    return np.concatenate(verts), np.concatenate(faces)


def procedural_bunny() -> Tuple[np.ndarray, np.ndarray]:
    """Low-poly bunny-silhouette stand-in: body, head, two ears and a tail
    as placed icospheres in the model-local [0,1]^3 box."""
    s = icosphere_mesh(1)
    return _union(
        [
            _placed(s, (0.56, 0.52, 0.70), (0.50, 0.30, 0.45)),  # body
            _placed(s, (0.34, 0.34, 0.34), (0.50, 0.62, 0.72)),  # head
            _placed(s, (0.12, 0.34, 0.14), (0.42, 0.86, 0.62)),  # ear L
            _placed(s, (0.12, 0.34, 0.14), (0.58, 0.86, 0.62)),  # ear R
            _placed(s, (0.16, 0.16, 0.16), (0.50, 0.28, 0.06)),  # tail
        ]
    )


def procedural_logo() -> Tuple[np.ndarray, np.ndarray]:
    """Extruded chevron-glyph stand-in: two slanted bars forming a 'Λ' plus
    a center bar, in [0,1]^3."""
    c = cube_mesh()

    def slanted(center, angle_deg):
        v, f = _placed(c, (0.16, 0.62, 0.22), center)
        a = math.radians(angle_deg)
        rot = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
        pivot = np.asarray(center)
        return (v - pivot) @ rot.T + pivot, f

    return _union(
        [
            slanted((0.30, 0.45, 0.5), -28.0),
            slanted((0.70, 0.45, 0.5), 28.0),
            _placed(c, (0.16, 0.40, 0.22), (0.50, 0.62, 0.5)),
        ]
    )


def _anim_period(cfg: StaticObjectConfig) -> float:
    if cfg.animation and cfg.animation.translation:
        return cfg.animation.translation.duration * 2.0
    return 1.0
