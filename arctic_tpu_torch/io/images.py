"""Image IO without Pillow: PNG decode and encode with zlib and numpy, and
the Radiance HDR (RGBE) codec. Port of arctic_tpu/io/images.py, whose LDR
half goes through Pillow (the card's machine has none).

PNG decode covers bit depth 8 in every colour type (gray, RGB, palette,
gray + alpha, RGBA), tRNS transparency, the five row filters, IDAT split
over several chunks and each chunk's CRC; it returns what Pillow's
``convert("RGBA")`` returns. Any other PNG (interlaced, 16-bit, sub-byte)
raises RenderError. JPEG goes through Pillow where Pillow imports, and
raises RenderError where it does not. The HDR arithmetic is the JAX
package's numpy path, bit for bit (the optional C++ helper of the JAX
package, io/native.py, is not ported).
"""

from __future__ import annotations

import zlib

import numpy as np

from arctic_tpu_torch.utils.errors import RenderError

PNG_ZLIB_LEVEL = 6  # zlib's default speed/size trade
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# Bytes per pixel of each 8-bit colour type.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(data: bytes, name: str):
    """(kind, body) of each chunk up to IEND, each CRC checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        n = int.from_bytes(data[pos : pos + 4], "big")
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        crc = data[pos + 8 + n : pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise RenderError(f"{name}: PNG chunk {kind!r} is cut short")
        if zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            raise RenderError(f"{name}: bad CRC in PNG chunk {kind!r}")
        pos += 12 + n
        yield kind, body
        if kind == b"IEND":
            return
    raise RenderError(f"{name}: PNG has no IEND chunk")


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int, name: str) -> np.ndarray:
    """(h, 1 + w * bpp) filtered rows -> (h, w, bpp) u8. Rows of filters
    None / Sub / Up go one numpy step a row; with any Average or Paeth row
    the image goes along anti-diagonals: pixel (y, x) depends only on (y,
    x-1), (y-1, x) and (y-1, x-1), so each diagonal is one vectorised step
    whatever the rows' filter types."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise RenderError(f"{name}: unknown PNG filter type {int(ftype.max())}")
    px = raw[:, 1:].reshape(h, w, bpp)
    if ftype.max(initial=0) <= 2:
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            row = px[y]
            if ftype[y] == 1:
                row = (np.cumsum(row, axis=0, dtype=np.int64) & 255).astype(np.uint8)
            elif ftype[y] == 2:
                row = row + prev  # u8 arithmetic wraps mod 256
            out[y] = prev = row
        return out
    ft = ftype.astype(np.int16)
    src = px.astype(np.int16)
    out = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row above, column left
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) // 2, paeth], 0)
        out[y + 1, x + 1] = (src[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """PNG bytes -> (H, W, 4) u8 RGBA, as Pillow's ``convert("RGBA")``."""
    if data[:8] != PNG_SIGNATURE:
        raise RenderError(f"{name}: not a PNG")
    ihdr, plte, trns, idat = None, None, None, []
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or len(ihdr) != 13 or not idat:
        raise RenderError(f"{name}: PNG without a valid IHDR or any IDAT chunk")
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    depth, ctype, comp, filt, interlace = ihdr[8:13]
    if depth != 8:
        raise RenderError(f"{name}: PNG bit depth {depth} is not supported (only 8)")
    if ctype not in _PNG_CHANNELS:
        raise RenderError(f"{name}: PNG colour type {ctype} is not valid")
    if interlace:
        raise RenderError(f"{name}: interlaced (Adam7) PNGs are not supported")
    if comp or filt:
        raise RenderError(f"{name}: PNG compression method {comp} / filter method {filt} "
                          f"is not valid")
    if w == 0 or h == 0:
        raise RenderError(f"{name}: PNG of size {w}x{h}")
    bpp = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise RenderError(f"{name}: PNG image data does not inflate: {e}") from e
    if len(raw) != h * (1 + w * bpp):
        raise RenderError(f"{name}: {len(raw)} bytes of PNG image data for {w}x{h}x{bpp}")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp), h, w, bpp, name)

    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if plte is None or len(plte) % 3 or not plte:
            raise RenderError(f"{name}: palette PNG without a valid PLTE chunk")
        n = len(plte) // 3
        idx = px[..., 0]
        if int(idx.max()) >= n:
            raise RenderError(f"{name}: palette index {int(idx.max())} past the "
                              f"{n}-entry PLTE")
        lut = np.full((n, 4), 255, np.uint8)
        lut[:, :3] = np.frombuffer(plte, np.uint8).reshape(n, 3)
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:n]
            lut[: len(alpha), 3] = alpha
        return lut[idx]
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., :3]
    if ctype in (4, 6):
        out[..., 3] = px[..., -1]
    else:
        out[..., 3] = 255
        if trns is not None:  # one colour made transparent (16-bit samples)
            key = np.frombuffer(trns, ">u2")[: 1 if ctype == 0 else 3].astype(np.int32)
            if len(key) == (1 if ctype == 0 else 3):
                out[(px.astype(np.int32) == key).all(axis=-1), 3] = 0
    return out


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) / (H, W, 1) gray, (H, W, 3) RGB or (H, W, 4) RGBA u8 -> PNG
    bytes (every row filtered Up, one IDAT chunk)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise RenderError(f"encode_png: u8 images only, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4) or 0 in img.shape[:2]:
        raise RenderError(f"encode_png: a gray, RGB or RGBA image, got shape {img.shape}")
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 2  # Up
    flat = img.reshape(h, w * c)
    rows[0, 1:] = flat[0]
    rows[1:, 1:] = flat[1:] - flat[:-1]  # u8 arithmetic wraps mod 256

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, ctype, 0, 0, 0])
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_ZLIB_LEVEL)) + chunk(b"IEND", b""))


def decode_ldr(data: bytes, name: str = "<image>") -> np.ndarray:
    """An 8-bit image's bytes -> (H, W, 4) u8 RGBA (stbi_load ..., 4),
    dispatched on the signature: PNG here, JPEG through Pillow."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name)
    if data[:3] == JPEG_SIGNATURE:
        try:
            from PIL import Image
        except ImportError as e:
            raise RenderError(f"{name}: JPEG textures need Pillow, which is not installed "
                              f"(PNG and HDR need nothing beyond numpy)") from e
        import io

        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    raise RenderError(f"{name}: not a PNG or JPEG image (signature {data[:8]!r})")


def load_ldr(path: str) -> np.ndarray:
    """Load an 8-bit image as (H, W, 4) u8 RGBA (stbi_load ..., 4)."""
    with open(path, "rb") as f:
        return decode_ldr(f.read(), path)


def save_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ----------------------------- Radiance HDR --------------------------------


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) u8 RGBE -> (..., 3) f32 linear (stb __hdr_convert rule)."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb, np.float32)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, exp = np.frexp(np.where(nz, maxc, 1.0))
    scale = mant * 256.0 / np.where(nz, maxc, 1.0)
    out[..., :3] = np.clip(rgb * (scale * nz)[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return out


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE, RLE or flat) -> (H, W, 3) f32 linear, through
    the optional native library where it is built (io/native.py), else
    load_hdr_np."""
    from arctic_tpu_torch.io import native

    if native.available():
        try:
            return native.load_hdr(path)
        except IOError:
            pass  # the numpy decoder names what is wrong with the file
    return load_hdr_np(path)


def load_hdr_np(path: str) -> np.ndarray:
    """The numpy Radiance .hdr decoder."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: lines until blank, then resolution line.
    pos = 0

    def line():
        nonlocal pos
        end = data.index(b"\n", pos)
        s = data[pos:end]
        pos = end + 1
        return s

    magic = line()
    if not (magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        ln = line()
        if ln == b"":
            break
    res = line().split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])

    img = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, count=len(data) - pos, offset=pos)
    bp = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2 or (buf[bp + 2] & 0x80):
            # Flat (or old-RLE, unsupported) scanline format.
            row = buf[bp : bp + w * 4].reshape(w, 4)
            img[y] = row
            bp += w * 4
            continue
        if (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != w:
            raise ValueError(f"{path}: RLE scanline {y} is not {w} pixels wide")
        bp += 4
        for c in range(4):
            x = 0
            while x < w:
                cnt = int(buf[bp])
                if cnt > 128:  # run
                    img[y, x : x + cnt - 128, c] = buf[bp + 1]
                    x += cnt - 128
                    bp += 2
                else:  # literal
                    img[y, x : x + cnt, c] = buf[bp + 1 : bp + 1 + cnt]
                    x += cnt
                    bp += 1 + cnt
    return _rgbe_to_float(img)


def save_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a flat (non-RLE) Radiance HDR file."""
    rgbe = _float_to_rgbe(rgb)
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
