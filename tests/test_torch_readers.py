"""The port's PNG codec and dataset readers against Pillow and the JAX
package's readers.

Test 1: PNGs that Pillow wrote (8-bit grey, RGB and RGBA, 16-bit grey;
noisy and smooth content, so that Pillow's adaptive filter choice uses
None, Sub, Up and Paeth; Pillow's writer never chooses Average), the same
images written with the five row filters in turn (encoded here), and
those the port's ``write_png`` wrote with each filter type and with
libpng's choice per row (at least three types chosen), read by
``io/png.py`` and by Pillow in each mode: equal, bit for bit. The files
use all five filters (checked).
An interlaced and a palette PNG raise.

Test 2: a KITTI-layout directory (with a label directory) and a
TUM-layout one, built as in test_cli.py, read by both packages' readers:
every field equal, bit for bit, and the ground-truth readers and writer
equal.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from semantic_slam_mapping_tpu.io import gt_pose as jgt
from semantic_slam_mapping_tpu.io.kitti import KittiReader as JKitti
from semantic_slam_mapping_tpu.io.tum import TumReader as JTum
from semantic_slam_mapping_torch.io import gt_pose as tgt
from semantic_slam_mapping_torch.io import png
from semantic_slam_mapping_torch.io.kitti import KittiReader as TKitti
from semantic_slam_mapping_torch.io.tum import TumReader as TTum

from tests.test_cli import kitti_dataset, tum_dataset  # noqa: F401


def _filter_types(path) -> set:
    """The row filter types a PNG file uses."""
    data = path.read_bytes()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            W, H, depth, ctype = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, -1)
    return set(rows[:, 0].tolist())


def _write_filtered(path, img: np.ndarray) -> None:
    """A PNG of ``img`` (uint8 grey/RGB/RGBA or uint16 grey) whose row y
    uses filter type y % 5."""
    H, W = img.shape[:2]
    ctype = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1], 0)}[img.ndim]
    depth = 16 if img.dtype == np.uint16 else 8
    px = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = px.reshape(H, -1).astype(np.int32)
    bpp = rows.shape[1] // W
    out = []
    for y in range(H):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][y % 5]
        out.append(np.concatenate([[y % 5], (cur - pred) % 256]))
    raw = np.concatenate(out).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                                  ctype, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))


def _pillow(path, mode):
    with Image.open(path) as im:
        return np.asarray(im if mode is None else im.convert(mode))


def test_png_codec_matches_pillow(tmp_path):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:48, :61]
    ramp = ((3 * xx + 5 * yy) % 256).astype(np.uint8)
    used, n_files = set(), 0
    for channels, mode in ((1, "L"), (3, "RGB"), (4, "RGBA")):
        shape = (48, 61) if channels == 1 else (48, 61, channels)
        r = ramp if channels == 1 else np.repeat(ramp[..., None], channels,
                                                 -1)
        noise = rng.integers(0, 256, shape, dtype=np.uint8)
        for content in (noise, r, r // 2 + noise // 8,
                        (r.astype(int) + rng.integers(-2, 3, shape))
                        .clip(0, 255).astype(np.uint8)):
            for writer in ("pillow", "cycled"):
                path = tmp_path / f"{mode}_{n_files}_{writer}.png"
                if writer == "pillow":
                    Image.fromarray(content, mode).save(path)
                else:
                    _write_filtered(path, content)
                used |= _filter_types(path)
                for m in (None, "L", "RGB"):
                    got, want = png.read_png(path, m), _pillow(path, m)
                    assert got.dtype == want.dtype
                    assert got.shape == want.shape
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{path.name} {m}")
            n_files += 1
    # 16-bit grey, big-endian in the file
    for content in (rng.integers(0, 65536, (30, 41)),
                    (np.add.outer(np.arange(30), np.arange(41)) * 977)):
        for writer in ("pillow", "cycled"):
            path = tmp_path / f"d16_{n_files}_{writer}.png"
            if writer == "pillow":
                Image.fromarray(content.astype(np.uint16)).save(path)
            else:
                _write_filtered(path, content.astype(np.uint16))
            used |= _filter_types(path)
            got, want = png.read_png(path), _pillow(path, None)
            assert got.dtype == np.uint16
            np.testing.assert_array_equal(got, want.astype(np.uint16))
        n_files += 1
    assert used == {0, 1, 2, 3, 4}, used

    # the port's writer (each filter type, and libpng's choice per row,
    # with a text chunk), read by Pillow
    chosen = set()
    for a in (rng.integers(0, 256, (20, 33, 3), dtype=np.uint8),
              rng.integers(0, 65536, (20, 33)).astype(np.uint16),
              ramp, r // 2 + noise // 8):
        for f in (0, 1, 2, 3, 4, None):
            path = tmp_path / f"w{a.ndim}.png"
            png.write_png(path, a, text={"Comment": "port"}, row_filter=f)
            types = _filter_types(path)
            if f is None:
                chosen |= types
            else:
                assert types == {f}
            np.testing.assert_array_equal(_pillow(path, None).astype(
                a.dtype), a, err_msg=f"filter {f}")
            np.testing.assert_array_equal(png.read_png(path), a)
            with Image.open(path) as im:
                assert im.text == {"Comment": "port"}
    assert len(chosen) >= 3, chosen

    # unsupported files raise: an Adam7-interlaced header, a palette
    path = tmp_path / "w2.png"
    png.write_png(path, rng.integers(0, 256, (8, 8), dtype=np.uint8))
    data = bytearray(path.read_bytes())
    data[28] = 1                                   # IHDR interlace method
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(path)
    path = tmp_path / "p.png"
    Image.fromarray(ramp, "L").convert("P").save(path)
    with pytest.raises(ValueError, match="palette"):
        png.read_png(path)


def _assert_frames_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
        elif name == "index":
            assert x == y
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_readers_match_jax(kitti_dataset, tum_dataset):  # noqa: F811
    root, gt_file, _ = kitti_dataset
    # a label directory, as the segnet pass writes it
    rng = np.random.default_rng(3)
    (root / "labels").mkdir(exist_ok=True)
    for i in range(6):
        lab = rng.integers(0, 12, (128, 384), dtype=np.uint8)
        Image.fromarray(lab, "L").save(root / "labels" / f"{i:06d}.png")
    jr = JKitti(str(root), start_index=1, end_index=5, semantic_dir="labels")
    tr = TKitti(str(root), start_index=1, end_index=5, semantic_dir="labels")
    assert len(jr) == len(tr) == 4
    for a, b in zip(jr, tr):
        _assert_frames_equal(a, b)
        assert b.semantic.dtype == np.int32 and b.color is not None

    jt, tt = JTum(str(tum_dataset), depth_scale=1000.0), \
        TTum(str(tum_dataset), depth_scale=1000.0)
    assert len(jt) == len(tt) == 5 and jt.timestamps == tt.timestamps
    for a, b in zip(jt, tt):
        _assert_frames_equal(a, b)
        assert b.depth.dtype == np.float32 and b.depth.max() > 1.0

    poses = tgt.read_kitti_poses(gt_file)
    np.testing.assert_array_equal(poses, jgt.read_kitti_poses(gt_file))
    ts_t, p_t = tgt.read_tum_trajectory(tum_dataset / "groundtruth.txt")
    ts_j, p_j = jgt.read_tum_trajectory(tum_dataset / "groundtruth.txt")
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(p_t, p_j)
