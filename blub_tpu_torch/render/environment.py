"""Lighting environment: directional sun + SH3 indirect + background plane/sky.

Ports of the reference's lighting stack:
- sh.glsl:20-46 (sh3Evaluate / sh3EvaluateCosine),
- brdf.glsl:4-27 (dielectric Fresnel, Schlick, normalized Blinn-Phong),
- background.glsl:25-66 (box-filtered grid ground plane, background sample),
- mesh.frag:13-27 (albedo/pi BRDF, direct + 4x cosine-SH indirect),
- src/renderer/background.rs:11-16 (BackgroundConfig).

LIGHTING holds the reference's shipped constants (background/config.json —
data, like the scene JSONs: sun direction/radiance and the 9 RGB indirect SH
coefficients baked from the "Rustig Koppie" HDRI with the sun removed).

Deviation: the reference displays an RGBE cubemap for the sky; that asset is a
git-lfs pointer here, so the sky is synthesized from the same lighting data —
the SH3 radiance reconstruction (the reference's own VISUALIZE_SH_RADIANCE
mode, background_render.frag:25-27) exposure-boosted to cubemap-like
brightness, plus a sun disk at the directional light.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

_B0 = 0.282094792  # sh.glsl SH_FACTOR_BAND0
_B1 = 0.488602512
_B2N = 1.092548431
_B2Z = 0.315391565
_CB0 = 0.886226925  # cosine-convolved factors
_CB1 = 1.023326708
_CB2N = 0.858085531
_CB2Z = 0.247707956


@dataclasses.dataclass
class Lighting:
    """BackgroundConfig analog (background.rs:11-16)."""

    dir_light_direction: np.ndarray  # unit, pointing FROM the sun
    dir_light_radiance: np.ndarray
    sh3: np.ndarray  # [9, 3] indirect radiance SH (sun removed)

    @staticmethod
    def from_config(path: str | pathlib.Path) -> "Lighting":
        d = json.loads(pathlib.Path(path).read_text())
        ld = d["dir_light_direction"]
        lr = d["dir_light_radiance"]
        v = np.asarray([ld["x"], ld["y"], ld["z"]], np.float32)
        return Lighting(
            dir_light_direction=v / np.linalg.norm(v),
            dir_light_radiance=np.asarray([lr["x"], lr["y"], lr["z"]], np.float32),
            sh3=np.asarray(d["indirect_lighting_sh"], np.float32),
        )


def _default_lighting() -> Lighting:
    v = np.asarray([-0.8051783, -0.47414306, -0.3561970], np.float32)
    return Lighting(
        dir_light_direction=v / np.linalg.norm(v),
        dir_light_radiance=np.asarray([2.06848, 2.15040, 2.02752], np.float32),
        sh3=np.asarray(
            [
                [0.028567474, 0.03285628, 0.04647888],
                [0.0025092107, -0.0058790953, -0.022086091],
                [0.0022966, 0.004311052, 0.0068791276],
                [-0.011607582, -0.015209086, -0.020231899],
                [0.00993983, 0.011832375, 0.015149615],
                [-0.005445027, -0.0059492975, -0.007428746],
                [-0.0018776592, -0.001985044, -0.0019327109],
                [-0.008734052, -0.009435011, -0.011537199],
                [0.011763511, 0.017065605, 0.023522936],
            ],
            np.float32,
        ),
    )


LIGHTING = _default_lighting()

# SH radiance -> display sky: the SH coefficients are faint HDR radiance
# (band0 ~0.03); the shipped cubemap is display-bright. Single scalar exposure.
SKY_EXPOSURE = 28.0


def sh3_evaluate(dirs: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """sh.glsl:20-32. dirs [..., 3] unit -> radiance [..., 3], clamped >= 0."""
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    r = (
        coeffs[0] * _B0
        + coeffs[1] * (-_B1) * y
        + coeffs[2] * _B1 * z
        + coeffs[3] * (-_B1) * x
        + coeffs[4] * _B2N * y * x
        + coeffs[5] * (-_B2N) * y * z
        + coeffs[6] * _B2Z * (3.0 * z * z - 1.0)
        + coeffs[7] * (-_B2N) * x * z
        + coeffs[8] * _B2N * 0.5 * (x * x - y * y)
    )
    return np.maximum(r, 0.0)


def sh3_evaluate_cosine(dirs: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """sh.glsl:34-46: irradiance (cosine-convolved) for a surface normal."""
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    r = (
        coeffs[0] * _CB0
        + coeffs[1] * (-_CB1) * y
        + coeffs[2] * _CB1 * z
        + coeffs[3] * (-_CB1) * x
        + coeffs[4] * _CB2N * y * x
        + coeffs[5] * (-_CB2N) * y * z
        + coeffs[6] * _CB2Z * (3.0 * z * z - 1.0)
        + coeffs[7] * (-_CB2N) * x * z
        + coeffs[8] * _CB2N * 0.5 * (x * x - y * y)
    )
    return np.maximum(r, 0.0)


def fresnel_dielectric(cos_theta: np.ndarray, eta: float) -> np.ndarray:
    """brdf.glsl:4-13 (Lagarde's dielectric-dielectric Fresnel)."""
    c = np.asarray(cos_theta, np.float32)
    temp = eta * eta + c * c - 1.0
    g = np.sqrt(np.maximum(temp, 0.0))
    num = 0.5 * ((g - c) / np.maximum(g + c, 1e-9)) ** 2
    frac = ((g + c) * c - 1.0) / np.where(np.abs((g - c) * c + 1.0) < 1e-9, 1e-9, (g - c) * c + 1.0)
    out = num * (1.0 + frac**2)
    return np.where(temp < 0.0, 1.0, out).astype(np.float32)


def schlick_fresnel(n_dot_v: np.ndarray, r0: float) -> np.ndarray:
    """brdf.glsl:15-19."""
    base = 1.0 - np.clip(n_dot_v, 0.0, 1.0)
    e = base**5
    return e + r0 * (1.0 - e)


def blinn_phong(exponent: float, normal, to_camera, to_light) -> np.ndarray:
    """brdf.glsl:21-27 (normalized Blinn-Phong)."""
    h = to_camera + to_light
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-9)
    s = np.clip(np.sum(normal * h, axis=-1), 0.0, 1.0) ** exponent
    return s * (exponent + 2.0) / (4.0 * np.pi)


def shade_surface(normal: np.ndarray, albedo: np.ndarray, lighting: Lighting = None) -> np.ndarray:
    """mesh.frag:13-27: brdf = albedo/pi; direct sun + 4x cosine-SH indirect."""
    lt = lighting or LIGHTING
    brdf = albedo / np.pi
    ndl = np.clip(np.sum(normal * -lt.dir_light_direction, axis=-1, keepdims=True), 0.0, 1.0)
    radiance = brdf * ndl * lt.dir_light_radiance
    radiance = radiance + brdf * sh3_evaluate_cosine(normal, lt.sh3) * 4.0
    return radiance


def sh_sky_color(dirs: np.ndarray, lighting: Lighting = None) -> np.ndarray:
    """Cubemap stand-in: SH3 radiance reconstruction + sun disk (see module
    docstring Deviation note). dirs [..., 3] unit -> rgb."""
    lt = lighting or LIGHTING
    base = sh3_evaluate(dirs, lt.sh3) * SKY_EXPOSURE
    cos_sun = np.sum(dirs * -lt.dir_light_direction, axis=-1, keepdims=True)
    disk = np.clip((cos_sun - 0.9995) / 0.0005, 0.0, 1.0) ** 2
    glow = np.clip(cos_sun, 0.0, 1.0) ** 64
    return base + lt.dir_light_radiance * (3.0 * disk + 0.15 * glow)


# optional RGBE cubemap sky (render/cubemap.py) — the reference's actual sky
# display path (background.glsl:15-21); None keeps the SH-synthesized sky
_SKY_CUBEMAP = None


def set_sky_cubemap(cubemap) -> None:
    """Install a render.cubemap.Cubemap as the sky (None to revert to SH)."""
    global _SKY_CUBEMAP
    _SKY_CUBEMAP = cubemap


def sky_color(dirs: np.ndarray, lighting: Lighting = None) -> np.ndarray:
    """Sky radiance for unit view dirs [..., 3]: the installed RGBE cubemap
    when present (sampleHdrCubemap), else the SH-synthesized stand-in."""
    if _SKY_CUBEMAP is not None:
        return _SKY_CUBEMAP.sample(dirs)
    return sh_sky_color(dirs, lighting)


def _grid_box_filter(p: np.ndarray, ddx: np.ndarray, ddy: np.ndarray, n: float) -> np.ndarray:
    """background.glsl:26-35 (Inigo Quilez box-filtered grid lines).
    p, ddx, ddy: [..., 2]."""
    p = p + 0.5 / n
    w = np.maximum(np.abs(ddx), np.abs(ddy)) + 0.01
    a = p + 0.5 * w
    b = p - 0.5 * w
    i = (np.floor(a) + np.minimum((a - np.floor(a)) * n, 1.0)
         - np.floor(b) - np.minimum((b - np.floor(b)) * n, 1.0)) / (n * w)
    return (1.0 - i[..., 0]) * (1.0 - i[..., 1])


def sample_background(
    position_w: np.ndarray,
    dirs: np.ndarray,
    lighting: Lighting = None,
):
    """background.glsl:37-66 sampleBackground, vectorized over an image of ray
    dirs. position_w is the camera position in WORLD units. Returns
    (rgb [...,3], t_hit [...] — world-space ray distance to the ground plane,
    +inf where the ray hits the sky/cubemap)."""
    lt = lighting or LIGHTING
    dy = dirs[..., 1]
    d = -(position_w[1] / np.where(np.abs(dy) < 1e-9, -1e-9, dy))
    plane_pos = position_w[None, None, :] + dirs * d[..., None]
    plane_size = 10.0
    on_plane = (
        (d > 0.0)
        & (np.abs(plane_pos[..., 0]) < plane_size)
        & (np.abs(plane_pos[..., 2]) < plane_size)
    )

    pxz = plane_pos[..., (0, 2)]
    # screen-space derivatives of the plane position (dFdx/dFdy analogs)
    ddx = np.gradient(pxz, axis=1)
    ddy = np.gradient(pxz, axis=0)
    big = ~np.isfinite(ddx) | (np.abs(ddx) > 1e3)
    ddx = np.where(big, 0.0, ddx)
    ddy = np.where(~np.isfinite(ddy) | (np.abs(ddy) > 1e3), 0.0, ddy)

    albedo = np.full(dirs.shape, 0.8, np.float32)
    g1 = _grid_box_filter(pxz * 10.0, ddx * 10.0, ddy * 10.0, 50.0)[..., None]
    albedo = 0.6 + (albedo - 0.6) * g1
    g2 = _grid_box_filter(pxz, ddx, ddy, 80.0)[..., None]
    albedo = 0.2 + (albedo - 0.2) * g2
    ground = albedo * lt.dir_light_radiance * (-lt.dir_light_direction[1])

    sky = sky_color(dirs, lt)
    rgb = np.where(on_plane[..., None], ground, sky).astype(np.float32)
    t_hit = np.where(on_plane, d, np.inf).astype(np.float32)
    return rgb, t_hit


def tonemap(rgb: np.ndarray) -> np.ndarray:
    """HdrBackbuffer tonemap (hdr_backbuffer.rs:92-93): linear -> sRGB only."""
    c = np.clip(rgb, 0.0, 1.0)
    return np.where(c <= 0.0031308, 12.92 * c, 1.055 * c ** (1.0 / 2.4) - 0.055)
