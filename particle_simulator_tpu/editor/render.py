"""Headless particle renderer: frames -> RGB images (PNG/PPM).

Functional equivalent of the reference editor's GPU renderer + shader
(particle_editor/src/graphics.rs, shader.wgsl), re-targeted at headless
operation (there is no display attached to a GPU host):

- particles render as discs with a **minimum on-screen size in px**
  (shader.wgsl:86-87) so single particles stay visible at any zoom;
- color = blue -> red by ``log2(1 + |v|) / log2(1 + max_speed)``
  (shader.wgsl:94,100) — the editor's velocity heat map;
- **velocity extrapolation**: when rendering at a playback time between
  frames, positions advance by ``vel * (sim_time - frame_time)``
  (shader.wgsl:96) so playback looks smooth at any frame rate;
- blend modes Over (overwrite) and Add (additive) (graphics.rs:195-204);
- null particles are culled (shader.wgsl:73-76).

PNG encoding is dependency-free (zlib + struct from the stdlib).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from particle_simulator_tpu.io.frame import Frame, U32_MAX

BLUE = np.array([0.2, 0.4, 1.0], dtype=np.float32)
RED = np.array([1.0, 0.25, 0.15], dtype=np.float32)


def velocity_colors(vx: np.ndarray, vy: np.ndarray, max_speed: float) -> np.ndarray:
    """(n, 3) f32 colors, blue -> red by log-speed (shader.wgsl:94,100)."""
    speed = np.hypot(vx.astype(np.float32), vy.astype(np.float32))
    t = np.log2(1.0 + speed, dtype=np.float32) / np.float32(np.log2(1.0 + max(max_speed, 1e-12)))
    t = np.clip(t, 0.0, 1.0)[:, None]
    return BLUE[None, :] * (1.0 - t) + RED[None, :] * t


def render_frame(
    frame: Frame,
    width: int = 512,
    height: int = 512,
    max_speed: float = 1000.0,
    min_px: float = 1.5,
    sim_time: float | None = None,
    frame_time: float = 0.0,
    blend: str = "over",
    style: str = "flat",
    background: tuple[float, float, float] = (0.05, 0.05, 0.08),
) -> np.ndarray:
    """Render a frame to an (height, width, 3) uint8 image.

    The image maps the full box; y is flipped so +y is up like the editor
    canvas.
    """
    img = np.empty((height, width, 3), dtype=np.float32)
    img[:] = np.asarray(background, dtype=np.float32)

    raw = frame.particles
    live = raw["ty"] >= 0
    n_live = int(np.count_nonzero(live))
    if n_live == 0:
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)
    # per-field views (no 20-byte structured copy of the whole array)
    all_live = n_live == len(raw)
    xs = raw["x"] if all_live else raw["x"][live]
    ys = raw["y"] if all_live else raw["y"][live]
    vxs = raw["vx"] if all_live else raw["vx"][live]
    vys = raw["vy"] if all_live else raw["vy"][live]

    # all-f32 pixel math: 24-bit mantissa >> the ~10 bits a canvas needs
    meta = frame.metadata
    px = xs.astype(np.float32) * np.float32(width / U32_MAX)
    py = ys.astype(np.float32) * np.float32(height / U32_MAX)

    if sim_time is not None:
        # velocity extrapolation (shader.wgsl:96)
        dt = sim_time - frame_time
        px = px + vxs * np.float32(dt * width / meta.box_width)
        py = py + vys * np.float32(dt * height / meta.box_height)

    py = np.float32(height) - py  # +y up, like the editor canvas

    # particle radius: physical sigma footprint, but never below min_px
    r_phys = 0.5 * meta.species(0).sigma / meta.box_width * width
    radius = max(float(min_px) / 2.0, r_phys)

    colors = velocity_colors(vxs, vys, max_speed)

    r_int = max(1, int(np.ceil(radius)))
    ix = np.floor(px).astype(np.int64)
    iy = np.floor(py).astype(np.int64)
    add = blend == "add"

    if n_live > 65536 and style == "flat":
        # dense fast path (the 1M-particle editor-rate case): particles per
        # pixel >> 1, so render color-accumulation buffers via bincount — one
        # vectorized pass instead of per-offset scatters
        ok = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        flat_idx = iy[ok] * width + ix[ok]
        npix = width * height
        count = np.bincount(flat_idx, minlength=npix).astype(np.float32)
        acc = np.empty((npix, 3), np.float32)
        for c in range(3):
            acc[:, c] = np.bincount(flat_idx, weights=colors[ok][:, c], minlength=npix)
        hit = count > 0
        mean_color = np.zeros((npix, 3), np.float32)
        mean_color[hit] = acc[hit] / count[hit, None]
        if add:
            # Add blend subtracts the background from each particle color
            # before accumulation (shader.wgsl:124 + graphics.rs:319-327):
            # out = bg + sum(color_i - bg), not bg + sum(color_i)
            bg = np.asarray(background, dtype=np.float32)
            img = img.reshape(npix, 3) + acc - count[:, None] * bg[None, :]
        else:
            img = np.where(hit[:, None], mean_color, img.reshape(npix, 3))
        return (np.clip(img.reshape(height, width, 3), 0.0, 1.0) * 255.0).astype(np.uint8)

    light = np.array([-0.5, -0.5, 0.707])  # upper-left light, like shiny_circle
    light /= np.linalg.norm(light)
    for dy in range(-r_int, r_int + 1):
        for dx in range(-r_int, r_int + 1):
            rr = dx * dx + dy * dy
            if rr > (radius + 0.5) ** 2:
                continue
            gx = ix + dx
            gy = iy + dy
            ok = (gx >= 0) & (gx < width) & (gy >= 0) & (gy < height)
            c = colors[ok]
            if style == "shaded":
                # fake-3D sphere: diffuse + specular from the surface normal
                # (the editor's "RTX Ultra" shiny_circle, shader.wgsl:179-201)
                nz = np.sqrt(max(0.0, 1.0 - rr / max(radius * radius, 1.0)))
                normal = np.array([dx / max(radius, 1.0), -dy / max(radius, 1.0), nz])
                nn = np.linalg.norm(normal)
                normal = normal / nn if nn > 0 else normal
                diff = max(0.15, float(normal @ light))
                spec = max(0.0, float(normal @ light)) ** 16
                c = np.clip(c * diff + spec * 0.6, 0.0, 1.0)
            if add:
                # background-subtracted additive blend (shader.wgsl:124)
                np.add.at(img, (gy[ok], gx[ok]), c - np.asarray(background, np.float32))
            else:
                img[gy[ok], gx[ok]] = c
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


# ---------------------------------------------------------------------------
# dependency-free image writers
# ---------------------------------------------------------------------------

def write_ppm(path: str, img: np.ndarray) -> None:
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (zlib deflate, filter 0)."""
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# Animated GIF output (the reference ships its states-of-matter demos as
# doc/*.gif; this is the dependency-free encoder for ours)
# ---------------------------------------------------------------------------

def _gif_quantize(img: np.ndarray) -> np.ndarray:
    """RGB8 -> palette indices in a fixed 6x7x6 color cube (252 entries) —
    plenty for the renderer's background + velocity heat ramp."""
    r = (img[..., 0].astype(np.uint16) * 5 + 127) // 255
    g = (img[..., 1].astype(np.uint16) * 6 + 127) // 255
    b = (img[..., 2].astype(np.uint16) * 5 + 127) // 255
    return (r * 42 + g * 6 + b).astype(np.uint8)


def _gif_palette() -> bytes:
    pal = bytearray()
    for r in range(6):
        for g in range(7):
            for b in range(6):
                pal += bytes((r * 255 // 5, g * 255 // 6, b * 255 // 5))
    pal += b"\x00" * (256 * 3 - len(pal))  # pad the 252-entry cube to 256
    return bytes(pal)


def _gif_lzw(indices: bytes, min_code: int = 8) -> bytes:
    """GIF-variant LZW: variable code width from min_code+1, table reset at
    4096 codes."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    out = bytearray()
    acc = 0
    nbits = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def fresh():
        return {bytes([i]): i for i in range(clear)}

    table = fresh()
    next_code = end + 1
    size = min_code + 1
    emit(clear, size)
    w = b""
    for byte in indices:
        wk = w + bytes([byte])
        if wk in table:
            w = wk
            continue
        emit(table[w], size)
        if next_code >= 4096:
            # table full: clear instead of adding (decoders never see a
            # 4096th entry), then restart narrow
            emit(clear, size)
            table = fresh()
            next_code = end + 1
            size = min_code + 1
        else:
            table[wk] = next_code
            next_code += 1
            # grow the code width one step AFTER next_code exceeds the
            # current size's capacity — decoders lag the encoder's table by
            # one entry, so this (not == 2^size) is the compatible boundary
            # (verified bit-exact against an independent decoder)
            if next_code == (1 << size) + 1 and size < 12:
                size += 1
        w = bytes([byte])
    if w:
        emit(table[w], size)
    emit(end, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, imgs, delay_cs: int = 8) -> None:
    """Animated, looping GIF89a from a sequence of (H, W, 3) uint8 frames."""
    imgs = list(imgs)
    if not imgs:
        raise ValueError("write_gif needs at least one frame")
    h, w, _ = imgs[0].shape
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _gif_palette()]
    # NETSCAPE loop-forever extension
    parts.append(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
    for img in imgs:
        # GCE: fields byte (no disposal/transparency), delay, transparent
        # index, terminator
        parts.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay_cs, 0, 0))
        parts.append(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
        data = _gif_lzw(_gif_quantize(img).tobytes())
        parts.append(bytes([8]))  # LZW min code size
        for i in range(0, len(data), 255):
            block = data[i : i + 255]
            parts.append(bytes([len(block)]) + block)
        parts.append(b"\x00")
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))
