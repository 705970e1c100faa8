"""Host triangle rasterizer — the MeshRenderer / VoxelRenderer analog
(src/renderer/mesh_renderer.rs:1-76, shader/mesh.vert/frag;
src/renderer/voxel_renderer.rs, shader/volume_visualization/
voxel_visualization.vert/frag).

Z-buffered barycentric rasterization with back-face culling (mesh_renderer.rs
sets cull_mode Back). Shading happens per pixel with the face normal —
mesh.frag's formula (albedo/pi * (direct sun + 4x cosine-SH indirect)) via
environment.shade_surface. The voxel debug mode turns occupancy surface voxels
into cube faces and shades them with |voxel velocity| * viz scale as albedo
(voxel_visualization.frag:17-24), which renders static solids black — same as
the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .camera import Camera
from .environment import Lighting, shade_surface

_FAR = 1e9


def rasterize_mesh(
    rgb: np.ndarray,
    depth: np.ndarray,
    camera: Camera,
    verts: np.ndarray,
    faces: np.ndarray,
    albedo: np.ndarray | float = 1.0,
    lighting: Optional[Lighting] = None,
    cull_backfaces: bool = True,
    face_uv: Optional[np.ndarray] = None,
    texture: Optional[np.ndarray] = None,
) -> None:
    """Rasterize a triangle mesh (grid-space verts f32[N,3], faces i32[M,3])
    into rgb/depth in place. albedo: scalar, [3], or per-face [M,3].

    With ``face_uv`` (f32[M,3,2], OBJ vt per corner) and ``texture``
    (f32[H,W,3], linear color), pixels sample the texture with
    perspective-correct interpolation and nearest-texel lookup, modulated by
    the face's lit albedo — the diffuse-texture path of the reference's mesh
    renderer (models.rs:184-224 + shader/mesh.frag). Real texture assets are
    git-lfs pointers in this checkout, so core/models.py substitutes a
    procedural checker."""
    if len(faces) == 0:
        return
    h, w = depth.shape
    px, py, z, valid = camera.project(verts, w, h)
    vx, vy, vz = px[faces], py[faces], z[faces]  # [M,3]
    vok = valid[faces].all(axis=1)

    # face normals in grid space (for shading) + back-face cull in screen space
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(nlen, 1e-12)
    area2 = (vx[:, 1] - vx[:, 0]) * (vy[:, 2] - vy[:, 0]) - (
        vx[:, 2] - vx[:, 0]
    ) * (vy[:, 1] - vy[:, 0])
    # screen y is flipped, so CCW world winding appears CW: cull area2 > 0
    keep = vok & (nlen[:, 0] > 1e-12) & ((area2 < -1e-9) | (not cull_backfaces))
    if not keep.any():
        return

    alb = np.broadcast_to(np.asarray(albedo, np.float32), (len(faces), 3))
    textured = face_uv is not None and texture is not None
    if textured:
        # lit at albedo=1; the texture sample multiplies in per pixel
        face_rgb = shade_surface(n, np.ones_like(alb), lighting)  # [M,3]
        th, tw = texture.shape[:2]
    else:
        face_rgb = shade_surface(n, alb, lighting)  # [M,3]

    flat_d = depth.reshape(-1)
    flat_rgb = rgb.reshape(-1, 3)
    order = np.argsort(-np.min(vz[keep], axis=1))  # far-to-near for fewer overdraws
    idxs = np.nonzero(keep)[0][order]
    for fi in idxs:
        x0, x1, x2 = vx[fi]
        y0, y1, y2 = vy[fi]
        xa = max(int(np.floor(min(x0, x1, x2))), 0)
        xb = min(int(np.ceil(max(x0, x1, x2))) + 1, w)
        ya = max(int(np.floor(min(y0, y1, y2))), 0)
        yb = min(int(np.ceil(max(y0, y1, y2))) + 1, h)
        if xa >= xb or ya >= yb:
            continue
        xs = np.arange(xa, xb, dtype=np.float32)[None, :] + 0.0
        ys = np.arange(ya, yb, dtype=np.float32)[:, None] + 0.0
        d = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if abs(d) < 1e-12:
            continue
        l1 = ((xs - x0) * (y2 - y0) - (ys - y0) * (x2 - x0)) / d
        l2 = ((ys - y0) * (x1 - x0) - (xs - x0) * (y1 - y0)) / d
        l0 = 1.0 - l1 - l2
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        iz = l0 / vz[fi, 0] + l1 / vz[fi, 1] + l2 / vz[fi, 2]
        zpix = 1.0 / np.maximum(iz, 1e-9)
        yy, xx = np.nonzero(inside)
        lin = (ya + yy) * w + (xa + xx)
        zv = zpix[yy, xx].astype(np.float32)
        closer = zv < flat_d[lin]
        lin, zv = lin[closer], zv[closer]
        flat_d[lin] = zv
        if textured:
            yy, xx = yy[closer], xx[closer]
            (u0, v0), (u1, v1), (u2, v2) = face_uv[fi]
            # perspective-correct: interpolate uv/z, then divide by 1/z
            uoz = l0 / vz[fi, 0] * u0 + l1 / vz[fi, 1] * u1 + l2 / vz[fi, 2] * u2
            voz = l0 / vz[fi, 0] * v0 + l1 / vz[fi, 1] * v1 + l2 / vz[fi, 2] * v2
            u = uoz[yy, xx] * zv
            v = voz[yy, xx] * zv
            # OBJ vt origin is bottom-left; wrap then nearest texel
            tx = np.clip(((u % 1.0) * tw).astype(np.int32), 0, tw - 1)
            ty = np.clip((((1.0 - v) % 1.0) * th).astype(np.int32), 0, th - 1)
            flat_rgb[lin] = face_rgb[fi] * texture[ty, tx]
        else:
            flat_rgb[lin] = face_rgb[fi]


def cube_mesh() -> Tuple[np.ndarray, np.ndarray]:
    """Unit cube [0,1]^3, 12 CCW (outward) triangles."""
    v = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32
    )
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
    """Unit-diameter sphere centered at (0.5,0.5,0.5) — the stand-in solid for
    lfs-pointer models (core/models.py:303-311 uses the same sphere SDF)."""
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


def voxel_surface_mesh(
    occupancy: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exposed faces of occupied voxels as quads->triangles (the voxel debug
    renderer's cube instancing, voxel_visualization.vert:16-35, reduced to
    visible faces). Returns (verts grid-space f32[N,3], faces i32[M,3],
    face_cells i32[M,3] — the source voxel of each triangle, for the
    per-voxel velocity albedo of voxel_visualization.frag:17-24)."""
    occ = occupancy > 0.0
    verts, faces, face_cells = [], [], []
    # face definitions: (axis, side, 4 corner offsets CCW seen from outside)
    quads = {
        (0, 0): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
        (0, 1): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
        (1, 0): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
        (1, 1): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
        (2, 0): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
        (2, 1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    }
    for (axis, side), corners in quads.items():
        shifted = np.roll(occ, 1 - 2 * side, axis=axis)
        edge_idx = [0, -1][side]
        sl = tuple(slice(None) if a != axis else edge_idx for a in range(3))
        shifted[sl] = False
        exposed = occ & ~shifted
        cells = np.argwhere(exposed).astype(np.float32)
        if len(cells) == 0:
            continue
        quad = np.asarray(corners, np.float32)  # [4,3]
        vs = cells[:, None, :] + quad[None]  # [C,4,3]
        nbase = sum(len(v) for v in verts)
        verts.append(vs.reshape(-1, 3))
        idx = nbase + np.arange(len(cells))[:, None] * 4
        faces.append(np.concatenate([idx + [0, 1, 2], idx + [0, 2, 3]], axis=0))
        face_cells.append(np.concatenate([cells, cells], axis=0).astype(np.int32))
    if not verts:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0, 3), np.int32),
        )
    return (
        np.concatenate(verts),
        np.concatenate(faces).astype(np.int32),
        np.concatenate(face_cells),
    )
