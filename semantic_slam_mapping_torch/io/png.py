"""A PNG codec in numpy and ``zlib``: what KITTI and TUM ship and what the
command line writes, with no imaging library.

Reads non-interlaced 8-bit grey, 8-bit RGB, 8-bit RGBA and 16-bit grey
(big-endian in the file) images with any of the five row filters. Any
other file (a palette, 1/2/4-bit or 16-bit colour samples, Adam7
interlacing, a bad checksum) raises a ``ValueError`` that names what is
unsupported. :func:`read_png` with ``mode="L"`` or ``"RGB"`` gives what
``np.asarray(Image.open(path).convert(mode))`` gives with Pillow, bit for
bit: a colour image read as grey takes Pillow's fixed-point luma
``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``. :func:`write_png` writes
filter type 0 on every row, one other type, or each row's type as
libpng's default heuristic picks it, with optional ``tEXt`` chunks.

Unfiltering: None, Sub (a cumulative sum modulo 256 along the row) and Up
are vectorised along a row. Average and Paeth depend on the pixel to the
left and the row above, so a block of rows that uses them is decoded one
anti-diagonal of pixels at a time (every pixel of a diagonal depends only
on earlier diagonals): H + W - 1 numpy steps for the block, each over its
rows at once, on a skewed copy in which a diagonal is contiguous.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, name); 8-bit samples everywhere, and 16 for grey
_COLOR_TYPES = {0: (1, "grey"), 2: (3, "RGB"), 6: (4, "RGBA")}
_MODES = (None, "L", "RGB")


def _chunks(data: bytes, path):
    """(type, payload) of each chunk, checksums verified."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: bad {ctype!r} chunk")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left ``a``, above ``b`` and above-left ``c``
    (signed integer arrays): with p = a + b - c, |p - a| = |b - c|,
    |p - b| = |a - c| and |p - c| = |(b - c) + (a - c)|."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonal(raw: np.ndarray, ftype: np.ndarray,
                       prior: np.ndarray) -> np.ndarray:
    """Rows (n, W, bpp) of any filter types, the decoded row above them
    ``prior`` (W, bpp), by anti-diagonals. The pixels are held skewed,
    ``T[y + x + 2, y + 1] = out[y, x]``, so that a diagonal is one
    contiguous row of ``T``, its left and upper neighbours the row before
    (shifted by one) and its upper-left ones the row before that; row
    ``y + 1 = 0`` holds ``prior`` and the cells left of the image stay 0."""
    n, W, bpp = raw.shape
    K = n + W - 1
    ys = np.arange(n)[:, None]
    diag = ys + np.arange(W)                        # (n, W): y + x
    R = np.zeros((K, n, bpp), np.int16)
    R[diag, ys] = raw
    T = np.zeros((K + 2, n + 1, bpp), np.int16)
    T[1:W + 1, 0] = prior
    # the other types' predictors as (wa * a + wb * b) >> sh, per row
    wa, wb, sh = (np.array(w, np.int16)[ftype][:, None] for w in (
        (0, 1, 0, 1, 0), (0, 0, 1, 1, 0), (0, 0, 0, 1, 0)))
    paeth = ftype[:, None] == 4
    every, some = paeth.all(), paeth.any()
    for k in range(K):
        lo, hi = max(0, k - W + 1), min(n, k + 1)
        a, b, c = T[k + 1, lo + 1:hi + 1], T[k + 1, lo:hi], T[k, lo:hi]
        if every:
            pred = _paeth(a, b, c)
        else:
            pred = (wa[lo:hi] * a + wb[lo:hi] * b) >> sh[lo:hi]
            if some:
                pred = np.where(paeth[lo:hi], _paeth(a, b, c), pred)
        T[k + 2, lo + 1:hi + 1] = (R[k, lo:hi] + pred) & 255
    return T[diag + 2, ys + 1].astype(np.uint8)


def _unfilter(rows: np.ndarray, W: int, bpp: int, path) -> np.ndarray:
    """(H, 1 + W * bpp) filtered scanlines -> (H, W, bpp) bytes."""
    H = len(rows)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(ftype.max())}")
    raw = rows[:, 1:].reshape(H, W, bpp)
    out = np.empty_like(raw)
    zero = np.zeros((W, bpp), np.uint8)
    # rows before the first Average/Paeth row and after the last one go
    # row by row; the block from the first to the last by diagonals
    slow = np.nonzero(ftype >= 3)[0]
    lo, hi = (slow[0], slow[-1] + 1) if len(slow) else (H, H)

    def row(y):
        f, r = ftype[y], raw[y]
        if f == 0:
            out[y] = r
        elif f == 1:
            out[y] = np.cumsum(r, axis=0, dtype=np.uint8)
        else:
            out[y] = r + (out[y - 1] if y else zero)

    for y in range(lo):
        row(y)
    if len(slow):
        out[lo:hi] = _unfilter_diagonal(raw[lo:hi], ftype[lo:hi],
                                        out[lo - 1] if lo else zero)
    for y in range(hi, H):
        row(y)
    return out


def read_png(path: str | Path, mode: Optional[str] = None) -> np.ndarray:
    """Decode a PNG. ``mode=None`` gives the stored samples: (H, W) uint8
    or uint16 for grey, (H, W, 3) or (H, W, 4) uint8 for RGB or RGBA.
    ``"L"`` gives (H, W) uint8 grey and ``"RGB"`` (H, W, 3) uint8, as
    Pillow's ``convert`` does (a 16-bit image has neither)."""
    if mode not in _MODES:
        raise ValueError(f"read_png: unsupported mode {mode!r}")
    data = Path(path).read_bytes()
    header, idat = None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            raise ValueError(f"{path}: palette images are not supported")
        elif ctype[0:1].isupper() and ctype not in (b"IEND",):
            raise ValueError(f"{path}: unsupported critical chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype_, comp, filt, interlace = header
    if ctype_ not in _COLOR_TYPES:
        raise ValueError(f"{path}: colour type {ctype_} is not supported "
                         "(grey, RGB and RGBA are)")
    channels, name = _COLOR_TYPES[ctype_]
    if depth != 8 and not (depth == 16 and ctype_ == 0):
        raise ValueError(f"{path}: {depth}-bit {name} is not supported "
                         "(8-bit grey, RGB and RGBA, and 16-bit grey are)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not "
                         "supported")
    if comp or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    bpp = channels * depth // 8
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: image data of {buf.size} bytes, expected "
                         f"{H * (1 + W * bpp)}")
    px = _unfilter(buf.reshape(H, 1 + W * bpp), W, bpp, path)
    if depth == 16:
        img = px.reshape(H, W, 2).view(">u2")[..., 0].astype(np.uint16)
        if mode is not None:
            raise ValueError(f"{path}: a 16-bit image has no {mode!r} mode "
                             "here; read it with mode=None")
        return img
    img = px[..., 0] if channels == 1 else px
    if mode == "L" and channels > 1:
        rgb = img[..., :3].astype(np.uint32)
        img = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470
                + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
    elif mode == "RGB":
        img = (np.repeat(img[..., None], 3, axis=-1) if channels == 1
               else img[..., :3])
    return np.ascontiguousarray(img)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _filter_rows(rows: np.ndarray, bpp: int, row_filter: Optional[int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Filter (H, W * bpp) bytes: every row with type ``row_filter``, or,
    for None, each row with the type whose residuals, read as signed
    bytes, have the least sum of magnitudes (libpng's default choice; the
    lowest type on a tie). The predictors read the unfiltered bytes, so
    there is no recurrence. Returns (types (H,), residuals)."""
    x = rows.astype(np.int32)
    up = np.concatenate([np.zeros_like(x[:1]), x[:-1]])
    left = np.concatenate([np.zeros_like(x[:, :bpp]), x[:, :-bpp]], axis=1)
    ul = np.concatenate([np.zeros_like(up[:, :bpp]), up[:, :-bpp]], axis=1)
    preds = (0, left, up, (left + up) >> 1, _paeth(left, up, ul))
    types = range(5) if row_filter is None else (row_filter,)
    res = np.stack([(x - preds[t]) & 255 for t in types])
    cost = np.minimum(res, 256 - res).sum(axis=2)
    pick = cost.argmin(axis=0)
    chosen = np.asarray(types)[pick].astype(np.uint8)
    return chosen, res[pick, np.arange(len(x))].astype(np.uint8)


def write_png(path: str | Path, array: np.ndarray,
              text: Optional[Dict[str, str]] = None,
              row_filter: Optional[int] = 0) -> None:
    """Write (H, W) uint8 grey, (H, W) uint16 16-bit grey, or (H, W, 3) /
    (H, W, 4) uint8 RGB / RGBA, every row with filter type ``row_filter``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) or, for None, with the type
    libpng's default heuristic picks for that row; ``text`` adds a
    ``tEXt`` chunk per entry."""
    a = np.asarray(array)
    if a.dtype == np.uint16 and a.ndim == 2:
        depth, ctype, px = 16, 0, a.astype(">u2").view(np.uint8)
    elif a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3
                                                  and a.shape[2] in (3, 4))):
        depth = 8
        ctype = 0 if a.ndim == 2 else (2 if a.shape[2] == 3 else 6)
        px = a
    else:
        raise ValueError(f"write_png: unsupported array {a.shape} {a.dtype}")
    if row_filter is not None and row_filter not in range(5):
        raise ValueError(f"write_png: unknown row filter {row_filter}")
    H, W = a.shape[:2]
    rows = np.ascontiguousarray(px).reshape(H, -1)
    types = np.zeros(H, np.uint8)
    if row_filter != 0:
        types, rows = _filter_rows(rows, rows.shape[1] // W, row_filter)
    filtered = np.concatenate([types[:, None], rows], axis=1)
    parts = [_SIGNATURE,
             _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                         0, 0, 0))]
    for key, value in (text or {}).items():
        parts.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                            + value.encode("latin-1")))
    parts += [_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)),
              _chunk(b"IEND", b"")]
    Path(path).write_bytes(b"".join(parts))
