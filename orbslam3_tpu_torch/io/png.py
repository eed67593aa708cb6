"""A small PNG codec in `zlib` and `struct`: the port's stand-in for
`cv2.imread` / `cv2.imwrite` / `cv2.imencode`, which the card's machine lacks.

It decodes non-interlaced PNGs of colour type 0 (grey) and 2 (RGB) at 8 and
16 bits, under all five row filters, and encodes 8-bit grey and RGB and 16-bit
grey (a TUM RGB-D depth map). The read
modes follow OpenCV's (whose PNG reader is libpng):

- `IMREAD_GRAYSCALE`: RGB becomes grey by libpng's fixed-point weights (red
  9797, green 19234, blue 3737, a sum of 2^15; truncated at 8 bits, rounded
  at 16), then a 16-bit sample keeps its high byte (`png_set_strip_16`);
- `IMREAD_UNCHANGED`: the samples as stored, uint8 or uint16, an RGB image in
  OpenCV's BGR channel order.

An interlaced, palette or alpha PNG raises, naming the file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}
# libpng's png_set_rgb_to_gray(.., 0.299, 0.587) in 1/32768 (pngrtran.c)
_GREY_R, _GREY_G, _GREY_B = 9797, 19234, 32768 - 9797 - 19234


def _chunks(data: bytes, name: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{name}: truncated PNG (no IEND chunk)")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """(height, stride) uint8 rows with the five PNG filters undone."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{name}: image data shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pad = (-stride) % bpp
    for y in range(height):
        f, line = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            cur = line
        elif f == 1:  # Sub: a running sum along each of the bpp byte chains
            chains = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(chains, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif f == 2:  # Up
            cur = line + prev
        elif f in (3, 4):  # Average, Paeth: sequential along the row
            cur_b, up, raw_b = bytearray(stride), prev.tobytes(), line.tobytes()
            for x in range(stride):
                a = cur_b[x - bpp] if x >= bpp else 0
                b = up[x]
                if f == 3:
                    cur_b[x] = (raw_b[x] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_b[x] = (raw_b[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"{name}: unknown PNG row filter {f} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def decode(data: bytes, flags: int = IMREAD_GRAYSCALE, name: str = "<bytes>") -> np.ndarray:
    """The image in `data` (a PNG file's bytes) under OpenCV's `flags`."""
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {colour} is not supported "
                         "(grey and RGB only)")
    if depth not in (8, 16):
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported (8 or 16)")
    ch, nbytes = _CHANNELS[colour], depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height,
                     width * ch * nbytes, ch * nbytes, name)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(height, width, ch)
    else:
        img = rows.reshape(height, width, ch)
    if flags == IMREAD_UNCHANGED:
        return img[..., 0] if ch == 1 else np.ascontiguousarray(img[..., ::-1])
    if flags != IMREAD_GRAYSCALE:
        raise ValueError(f"unsupported read flags {flags}")
    if ch == 3:  # at 16 bits libpng rounds the weighted sum, at 8 it truncates
        rgb = img.astype(np.uint64)
        img = (_GREY_R * rgb[..., 0] + _GREY_G * rgb[..., 1] + _GREY_B * rgb[..., 2]
               + (1 << 14 if depth == 16 else 0)) >> 15
    else:
        img = img[..., 0]
    return (img >> 8 if depth == 16 else img).astype(np.uint8)


def imread(path: str, flags: int = IMREAD_GRAYSCALE) -> np.ndarray:
    """`cv2.imread(path, flags)` for the PNGs above; raises where OpenCV
    would return None (a missing file)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, flags, path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode(img: np.ndarray, text: dict | None = None) -> bytes:
    """PNG bytes of an 8-bit grey (H, W) or BGR (H, W, 3) image or a 16-bit
    grey (H, W) one, as `cv2.imencode(".png", img)[1]` decodes (16-bit
    samples big-endian, as PNG stores them); every row filter 0, zlib at
    OpenCV's default PNG compression level (1). `text` adds a `tEXt` chunk
    per key."""
    img = np.asarray(img)
    grey16 = img.dtype == np.uint16 and img.ndim == 2
    if not grey16 and (img.dtype != np.uint8 or img.ndim not in (2, 3)
                       or (img.ndim == 3 and img.shape[2] != 3)):
        raise ValueError(f"encode takes 8-bit grey or 3-channel images or 16-bit grey ones, "
                         f"got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    pixels = img if img.ndim == 2 else img[..., ::-1]  # BGR -> RGB
    if grey16:
        pixels = pixels.astype(">u2").view(np.uint8)
    rows = np.zeros((height, 1 + pixels[0].size), np.uint8)
    rows[:, 1:] = pixels.reshape(height, -1)
    out = [_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                                   16 if grey16 else 8, colour, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + str(value).encode("latin-1")))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def imwrite(path: str, img: np.ndarray) -> None:
    """`cv2.imwrite(path, img)` for 8-bit grey and BGR images and 16-bit grey
    ones."""
    with open(path, "wb") as f:
        f.write(encode(img))
