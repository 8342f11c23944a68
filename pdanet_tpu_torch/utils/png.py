"""PNG files with the standard library and numpy: the port reads KITTI's
camera images and depth maps without Pillow.

``read_png(path)`` decodes a non-interlaced PNG of 8-bit gray, gray +
alpha, RGB or RGBA pixels, or 16-bit gray (KITTI's depth maps): the IDAT
chunks inflated by zlib, then each row's filter (None, Sub, Up, Average,
Paeth) undone.  A row's Sub, Average and Paeth filters run along the row
and its Up, Average and Paeth filters read the row above, so the pixels are
reconstructed along antidiagonals (row + column constant), every row's
pixel of one antidiagonal at once.  ``encode_png(array)`` writes such a
file, each row with the filter given (None by default).
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> channels, for the types read here (no palette)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, height, width, bpp):
    """(height, 1 + width * bpp) filtered rows -> (height, width, bpp)
    uint8 bytes of the pixels."""
    ftype = raw[:, 0].astype(np.int64)
    filt = raw[:, 1:].reshape(height, width, bpp).astype(np.int64)
    if not ftype.any():
        return filt.astype(np.uint8)
    if ftype.max() > 4:
        raise ValueError(f"PNG filter type {ftype.max()}")
    out = np.zeros((height + 1, width + 1, bpp), np.int64)  # a zero row and column before
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        pred = np.stack([np.zeros_like(a), a, b, (a + b) // 2, _paeth(a, b, c)])
        out[r + 1, x + 1] = (filt[r, x] + pred[ftype[r], np.arange(len(r))]) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path):
    """The pixels of the PNG at ``path``: (H, W) for gray, (H, W, C) else;
    uint8, or uint16 for 16-bit gray."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color, _, _, interlace = header
    if interlace or color not in CHANNELS or depth not in (8, 16) or (
            depth == 16 and color != 0):
        raise ValueError(f"{path}: PNG of colour type {color}, depth {depth}, interlace "
                         f"{interlace} is not read here")
    bpp = CHANNELS[color] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pix = _unfilter(raw.reshape(height, 1 + width * bpp), height, width, bpp)
    if depth == 16:
        return pix.view(">u2")[..., 0].astype(np.uint16)
    return pix[..., 0] if color == 0 else pix


def encode_png(array, filter_type=0):
    """PNG bytes of an (H, W) uint8 / uint16 gray or (H, W, 3|4) uint8
    array, every row filtered with ``filter_type`` (0-4)."""
    array = np.asarray(array)
    height, width = array.shape[:2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[1 if array.ndim == 2 else array.shape[2]]
    depth = 16 if array.dtype == np.uint16 else 8
    pix = array.astype(">u2").view(np.uint8) if depth == 16 else array.astype(np.uint8)
    cur = pix.reshape(height, width, -1).astype(np.int64)
    bpp = cur.shape[2]
    a = np.zeros_like(cur)
    a[:, 1:] = cur[:, :-1]
    b = np.zeros_like(cur)
    b[1:] = cur[:-1]
    c = np.zeros_like(cur)
    c[1:, 1:] = cur[:-1, :-1]
    pred = [np.zeros_like(cur), a, b, (a + b) // 2, _paeth(a, b, c)][filter_type]
    rows = ((cur - pred) & 0xFF).astype(np.uint8).reshape(height, width * bpp)
    raw = np.concatenate([np.full((height, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color,
                                                   0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))
