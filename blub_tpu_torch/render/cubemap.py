"""RGBE cubemap sky: Radiance .hdr decode + cubemap sampling.

Port of the reference's cubemap display path:
- src/renderer/background.rs:47-140 (cubemap_loader: six RGBE8 faces
  px/nx/py/ny/pz/nz.hdr kept in rgbe8 form, decoded at sample time),
- shader/background.glsl:13-21 (decodeRGBE + sampleHdrCubemap, including the
  dir.zyx swizzle compensating the swapped x/z of Wumpf/hdr-cubemap-to-sh).

The shipped faces under reference background/ are git-lfs POINTERS here, so
`load_cubemap` falls back to `procedural_cubemap()` — six faces baked from the
same lighting config's SH sky — which exercises the identical RGBE8
encode/store/decode/sample path (the same strategy as the mesh-texture
checker).

A copy of ``blub_tpu/render/cubemap.py`` (numpy, on the host). The
renderer's fluid pass samples the same faces on its device
(``render/device_ssf.py::cubemap_sample``).

Deviation: decodeRGBE here is byte * 2^(e-136) (the standard Radiance
rgbe2float) where the reference GLSL computes (byte/255) * 2^(e-128); the two
differ by a uniform 256/255 (~0.4%) brightness factor.
"""

from __future__ import annotations

import pathlib

import numpy as np


def decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBE -> [..., 3] float32 (background.glsl:13)."""
    rgbe = np.asarray(rgbe)
    e = rgbe[..., 3:4].astype(np.int32)
    scale = np.exp2(e.astype(np.float32) - 136.0)
    out = rgbe[..., :3].astype(np.float32) * scale
    return np.where(e == 0, 0.0, out).astype(np.float32)


def encode_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float32 -> [..., 4] uint8 RGBE (standard float2rgbe)."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    m = rgb.max(axis=-1, keepdims=True)
    # frexp: m = f * 2^e with f in [0.5, 1); stored exponent byte is e+128,
    # so bytes = rgb * 2^(8-e) inverts decode's rgb = bytes * 2^((e+128)-136)
    _, e = np.frexp(m)
    scale = np.exp2(8.0 - e.astype(np.float32))
    bytes_ = np.clip(np.round(rgb * scale), 0, 255).astype(np.uint8)
    exp = np.clip(e + 128, 0, 255).astype(np.uint8)
    zero = m <= 1e-32
    out = np.concatenate([bytes_, np.where(zero, 0, exp)], axis=-1)
    out[..., :3] = np.where(zero, 0, out[..., :3])
    return out


def _read_hdr_scanline(data: bytes, off: int, width: int) -> tuple[np.ndarray, int]:
    """One scanline -> ([width, 4] uint8, new offset). Handles new-style RLE
    (header 0x02 0x02 hi lo, four channel-planar RLE streams) and flat RGBE."""
    if (
        width >= 8
        and width < 32768
        and data[off] == 2
        and data[off + 1] == 2
        and ((data[off + 2] << 8) | data[off + 3]) == width
    ):
        off += 4
        line = np.empty((4, width), np.uint8)
        for ch in range(4):
            x = 0
            while x < width:
                n = data[off]
                off += 1
                if n > 128:  # run of the same byte
                    line[ch, x : x + n - 128] = data[off]
                    off += 1
                    x += n - 128
                else:  # literal dump
                    line[ch, x : x + n] = np.frombuffer(data, np.uint8, n, off)
                    off += n
                    x += n
        return line.T.copy(), off
    # flat (non-RLE) scanline
    flat = np.frombuffer(data, np.uint8, width * 4, off).reshape(width, 4)
    return flat.copy(), off + width * 4


def load_hdr(path) -> np.ndarray:
    """Radiance .hdr -> [H, W, 4] uint8 RGBE (rgbe8 kept raw, like
    background.rs's cubemap texture). Raises ValueError on git-lfs pointers
    and non-Radiance files."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance .hdr file (git-lfs pointer?)")
    # header: lines until blank, then the resolution line "-Y H +X W"
    off = 0
    while True:
        nl = data.index(b"\n", off)
        line = data[off:nl]
        off = nl + 1
        if line == b"":
            break
        if line.startswith(b"FORMAT=") and b"32-bit_rle_rgbe" not in line:
            raise ValueError(f"{path}: unsupported FORMAT {line!r}")
    nl = data.index(b"\n", off)
    res = data[off:nl].split()
    off = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    rows = []
    for _ in range(h):
        row, off = _read_hdr_scanline(data, off, w)
        rows.append(row)
    return np.stack(rows)


def write_hdr(path, rgbe: np.ndarray) -> None:
    """Write [H, W, 4] uint8 RGBE as a flat (non-RLE) Radiance .hdr file."""
    h, w, _ = rgbe.shape
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    pathlib.Path(path).write_bytes(header + rgbe.astype(np.uint8).tobytes())


_FACES = ("px", "nx", "py", "ny", "pz", "nz")


class Cubemap:
    """Six RGBE8 faces [6, R, R, 4]; face order px,nx,py,ny,pz,nz
    (background.rs:103)."""

    def __init__(self, faces: np.ndarray):
        assert faces.shape[0] == 6 and faces.shape[1] == faces.shape[2]
        self.faces = np.ascontiguousarray(faces, np.uint8)

    def sample(self, dirs: np.ndarray) -> np.ndarray:
        """sampleHdrCubemap (background.glsl:15-21): [..., 3] unit dirs ->
        [..., 3] float32 radiance. Applies the reference's dir.zyx swizzle and
        GL cubemap face math; nearest sampling (the reference uses trilinear
        on an 8-bit texture — nearest at face resolution is visually
        indistinguishable for a sky and keeps this pure numpy)."""
        d = np.asarray(dirs, np.float32)[..., ::-1]  # .zyx swizzle
        x, y, z = d[..., 0], d[..., 1], d[..., 2]
        ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
        # GL face-select: largest-magnitude axis wins
        is_x = (ax >= ay) & (ax >= az)
        is_y = (ay > ax) & (ay >= az)
        ma = np.where(is_x, ax, np.where(is_y, ay, az))
        ma = np.maximum(ma, 1e-20)
        face = np.where(
            is_x,
            np.where(x >= 0, 0, 1),
            np.where(is_y, np.where(y >= 0, 2, 3), np.where(z >= 0, 4, 5)),
        )
        sc = np.where(
            is_x,
            np.where(x >= 0, -z, z),
            np.where(is_y, x, np.where(z >= 0, x, -x)),
        )
        tc = np.where(is_y, np.where(y >= 0, z, -z), -y)
        r = self.faces.shape[1]
        u = np.clip(((sc / ma + 1.0) * 0.5 * r).astype(np.int32), 0, r - 1)
        v = np.clip(((tc / ma + 1.0) * 0.5 * r).astype(np.int32), 0, r - 1)
        return decode_rgbe(self.faces[face, v, u])


def procedural_cubemap(resolution: int = 64, lighting=None) -> Cubemap:
    """Bake the SH-synthesized sky (environment.sky_color) into six RGBE8
    faces — the stand-in for the lfs-pointer .hdr assets. Every sample then
    runs the real RGBE decode + cubemap face math."""
    from .environment import sh_sky_color as sky_color

    faces = []
    for f in range(6):
        v_idx, u_idx = np.meshgrid(
            np.arange(resolution), np.arange(resolution), indexing="ij"
        )
        sc = (u_idx + 0.5) / resolution * 2.0 - 1.0
        tc = (v_idx + 0.5) / resolution * 2.0 - 1.0
        one = np.ones_like(sc)
        if f == 0:
            d = np.stack([one, -tc, -sc], -1)
        elif f == 1:
            d = np.stack([-one, -tc, sc], -1)
        elif f == 2:
            d = np.stack([sc, one, tc], -1)
        elif f == 3:
            d = np.stack([sc, -one, -tc], -1)
        elif f == 4:
            d = np.stack([sc, -tc, one], -1)
        else:
            d = np.stack([-sc, -tc, -one], -1)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        # faces store the swizzled-frame directions (sample() swizzles back)
        rgb = sky_color(d[..., ::-1], lighting)
        faces.append(encode_rgbe(rgb))
    return Cubemap(np.stack(faces))


def load_cubemap(dir_path, lighting=None) -> Cubemap:
    """Load px/nx/py/ny/pz/nz.hdr from a directory (background.rs:100-140);
    falls back to procedural_cubemap() when the files are git-lfs pointers or
    missing, with a loud warning."""
    dir_path = pathlib.Path(dir_path)
    try:
        faces = [load_hdr(dir_path / f"{n}.hdr") for n in _FACES]
        res = faces[0].shape[0]
        if any(f.shape != (res, res, 4) for f in faces):
            raise ValueError("cubemap faces must be square and equal-sized")
        return Cubemap(np.stack(faces))
    except (OSError, ValueError) as e:
        import logging

        logging.getLogger(__name__).warning(
            "cubemap %s unusable (%s) — using the PROCEDURAL SH-baked cubemap "
            "stand-in", dir_path, e,
        )
        return procedural_cubemap(lighting=lighting)
