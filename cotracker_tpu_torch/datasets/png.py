"""PNG files with the standard library's zlib and numpy, where OpenCV and PIL
are missing (the GPU machine has neither).

    read_png(path)            -> (H, W, 3) uint8 RGB
    read_pngs(paths)          -> the same for many files, decoded together
    write_png(path, img, filters=None), encode_png(img, filters=None) -> bytes

The reader returns what cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
returns for 8-bit, non-interlaced files: greyscale (colour type 0, and 4
with alpha) replicated to three channels, RGB (2) and RGBA (6) with the
alpha dropped, a palette (3) expanded. It raises a ValueError that names the
property it does not handle (another bit depth, interlacing, a chunk whose
CRC does not match).

Undoing the row filters: None, Sub and Up need only the row above or a
running sum, but Average and Paeth read the byte to the left, just
reconstructed. Every filter reads only the pixels at (y, x - 1), (y - 1, x)
and (y - 1, x - 1), so the pixels on one anti-diagonal y + x = d depend only
on the two diagonals before it: the decoder sweeps the H + W - 1 diagonals,
each one numpy step over all the files that share a size, with each row's
filter type applied by mask.
"""

import struct
import zlib
from typing import List, Optional, Sequence, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # bytes a pixel, by colour type
NONE, SUB, UP, AVERAGE, PAETH = range(5)


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, its CRC checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: the CRC of its {kind.decode('latin-1')} chunk does "
                             "not match")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG file (no IEND chunk)")


def _parse(path: str):
    """Header fields, the palette and the filtered rows (H, 1 + W * bpp)."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not handled (8-bit files only)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) files are not handled")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {H * (1 + W * bpp)}")
    rows = raw.reshape(H, 1 + W * bpp)
    if rows[:, 0].max(initial=0) > PAETH:
        raise ValueError(f"{path}: unknown row filter type {int(rows[:, 0].max())}")
    return (H, W, bpp), ctype, palette, rows


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: the one of a, b, c nearest to
    a + b - c, ties in that order."""
    db, da = b - c, a - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, W: int, bpp: int) -> np.ndarray:
    """(F, H, 1 + W * bpp) filtered rows of F images of one size (each row's
    filter type first) -> (F, H, W, bpp) uint8, by the diagonal sweep of the
    module docstring. The pixels live in an int16 buffer (H + 1, W + 1, F,
    bpp) with a zero row above and a zero column to the left, the images
    innermost; a strided view of it, sheared so that view[e, j] is
    buffer[j, e - j], makes each diagonal one slice."""
    F_, H = rows.shape[:2]
    types = rows[:, :, 0].T[:, :, None]  # (H, F, 1)
    masks = {k: np.ascontiguousarray(types == k) for k in (SUB, UP, AVERAGE, PAETH)
             if (types == k).any()}
    if not masks:  # every row unfiltered (type None)
        return np.ascontiguousarray(rows[:, :, 1:].reshape(F_, H, W, bpp))
    buf = np.zeros((H + 1, W + 1, F_, bpp), np.int16)
    src = np.zeros_like(buf)
    src[1:, 1:] = rows[:, :, 1:].reshape(F_, H, W, bpp).transpose(1, 2, 0, 3)

    def sheared(a):
        sh, sw, sf, sc = a.strides
        return np.lib.stride_tricks.as_strided(
            a, shape=(H + W + 1, H + 1, F_, bpp), strides=(sw, sh - sw, sf, sc))

    view, raw = sheared(buf), sheared(src)
    for d in range(H + W - 1):  # pixel (y, x) with y + x = d sits at view[d + 2, y + 1]
        y0, y1 = max(0, d - W + 1), min(H - 1, d) + 1
        e, j = d + 2, slice(y0 + 1, y1 + 1)
        left, up = view[e - 1, j], view[e - 1, y0:y1]
        pred = 0
        for kind, mask in masks.items():
            if kind == SUB:
                p = left
            elif kind == UP:
                p = up
            elif kind == AVERAGE:
                p = (left + up) >> 1
            else:
                p = _paeth(left, up, view[e - 2, y0:y1])
            pred = np.where(mask[y0:y1], p, pred)
        view[e, j] = (raw[e, j] + pred) & 255
    return buf[1:, 1:].transpose(2, 0, 1, 3).astype(np.uint8)


def _to_rgb(pix: np.ndarray, ctype: int, palette) -> np.ndarray:
    """(..., H, W, bpp) decoded bytes -> (..., H, W, 3) RGB, as IMREAD_COLOR."""
    if ctype == 3:
        if pix[..., 0].max(initial=0) >= len(palette):
            raise ValueError("a palette index past the end of the PLTE chunk")
        return palette[pix[..., 0]]
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode many PNG files; files of one size and pixel width are undone in
    one sweep. Returns one (H, W, 3) uint8 RGB array per path."""
    parsed = [_parse(p) for p in paths]
    out: List[Optional[np.ndarray]] = [None] * len(paths)
    groups = {}
    for i, (shape, _, _, _) in enumerate(parsed):
        groups.setdefault(shape, []).append(i)
    for (H, W, bpp), idx in groups.items():
        pix = _unfilter(np.stack([parsed[i][3] for i in idx]), W, bpp)
        for k, i in enumerate(idx):
            out[i] = _to_rgb(pix[k], parsed[i][1], parsed[i][2])
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG file (see the module docstring)."""
    return read_pngs([path])[0]


def _filter_rows(img: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Filter each row of (H, W, bpp) uint8 with its type: (H, 1 + W * bpp)."""
    H, W, bpp = img.shape
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)])
    filtered = (x[None] - preds).astype(np.uint8).reshape(5, H, W * bpp)
    if types is None:  # per row the filter of least sum of |signed byte| (PNG spec, 12.8)
        types = np.abs(filtered.astype(np.int8).astype(np.int32)).sum(axis=2).argmin(axis=0)
    rows = filtered[types, np.arange(H)]
    return np.concatenate([types.astype(np.uint8)[:, None], rows], axis=1)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img, filters: Union[None, int, Sequence[int]] = None) -> bytes:
    """The bytes of an 8-bit PNG file of (H, W) or (H, W, 1) greyscale,
    (H, W, 3) RGB or (H, W, 4) RGBA uint8. filters: None picks each row's
    filter by the PNG specification's heuristic (the least sum of absolute
    signed bytes), so a file mixes them by row; an int (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth) forces one on every row; a sequence gives one per
    row. zlib compresses at its default level, 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG files here hold uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    ctype = {1: 0, 3: 2, 4: 6}.get(img.shape[-1] if img.ndim == 3 else 0)
    if ctype is None:
        raise ValueError(f"PNG files here hold (H, W[, 1 | 3 | 4]) images, got {img.shape}")
    H, W, _ = img.shape
    types = None
    if filters is not None:
        types = np.broadcast_to(np.asarray(filters, np.int64), (H,))
        if types.min() < NONE or types.max() > PAETH:
            raise ValueError(f"filter types are 0-4, got {filters}")
    data = zlib.compress(_filter_rows(img, types).tobytes(), 6)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", data) + _chunk(b"IEND", b""))


def write_png(path: str, img, filters: Union[None, int, Sequence[int]] = None) -> None:
    """Write encode_png(img, filters) to `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))
