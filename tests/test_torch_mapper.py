"""The port's keyframe cloud and voxel maps against the JAX package's.

Test 1 holds ``pipeline._kf_cloud`` (and through it
``mapping.mapper.generate_point_cloud``) to the JAX package's jitted
``_kf_cloud_jit`` on a rendered 64x128 keyframe with sky, a pedestrian, a
moving car and the U-V moving mask, at cloud strides 1 and 2, with a band
of disparities planted so that their points fall on voxel boundaries where
a true division by the voxel size and XLA's multiply by its float32
reciprocal disagree. Tolerance: none, the quantized arrays and the counts
are equal. It also holds ``motion_overlay_fuse`` to JAX's in its three
cases (one component passes; none passes, so the semantic mask stays; a
large component fails on its overlay while a smaller one passes), with
components on the image edges, where the rolled neighbour masks wrap.

Test 2 holds the port's numpy ``GlobalMap`` and its C++
``NativeVoxelMap`` to JAX's ``GlobalMap`` over four inserts, voxels sorted
by key: the numpy maps are equal, the C++ map (float32 running means)
within 2e-5 in position and color, labels equal; ``write_pcd`` and
``save_pcd`` write the same bytes as JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.config import CameraConfig
from semantic_slam_mapping_tpu.config import MapperConfig as JMapperConfig
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JK
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_tpu.mapping import mapper as jmp
from semantic_slam_mapping_tpu.pipeline import _kf_cloud_jit
from semantic_slam_mapping_torch.config import MapperConfig
from semantic_slam_mapping_torch.mapping import mapper as tmp_
from semantic_slam_mapping_torch.mapping import semantics
from semantic_slam_mapping_torch.mapping.native import NativeVoxelMap
from semantic_slam_mapping_torch.pipeline import _kf_cloud
from semantic_slam_mapping_torch.utils import convert

H, W = 64, 128
CAM = CameraConfig(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, baseline=0.5)
JK_ = JK.from_config(CAM)
TK = convert.intrinsics_from_numpy(*JK_)


def _boundary_disparities(res=0.1, max_distance=40.0):
    """float16 disparities whose back-projected x or z, at some pixel
    column of the camera, floors to another voxel under a true division by
    ``res`` than under a multiply by float32(1 / res)."""
    d = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(np.float16)
    d = d[np.isfinite(d) & (d > 0.5)].astype(np.float32)
    bf = np.float32(CAM.fx) * np.float32(CAM.baseline)
    depth = bf / d
    inv = np.float32(1.0) / np.float32(res)
    hits = set()
    for u in range(W):
        x = (np.float32(u) - np.float32(CAM.cx)) * depth / np.float32(CAM.fx)
        for c in (x, depth):
            s = c + np.float32(max_distance)
            diff = (np.floor(s * inv) != np.floor(s / np.float32(res))) \
                & (depth < max_distance)
            hits.update(d[diff].tolist())
    return np.array(sorted(hits), np.float16)


def _keyframe():
    """A rendered keyframe: float16 disparity with a band of planted
    boundary disparities, float16 gray image, labels with pedestrian, sky
    and pole blocks, and the moving mask of the car."""
    world = jsyn.make_world(jax.random.PRNGKey(3), n_boxes=10,
                            with_moving_box=True)
    img, depth, sem, mov = (np.array(a) for a in
                            jsyn.render(JK_, jnp.eye(4), world, H, W))
    disp = np.where(depth > 0.3, float(JK_.bf) / np.maximum(depth, 0.3), 0.0)
    planted = _boundary_disparities()
    band = disp[40:56]
    band.flat[:] = np.resize(planted, band.size)
    sem = sem.copy()
    sem[20:44, 10:40] = semantics.PEDESTRIAN
    sem[:6, 64:] = semantics.SKY
    sem[6:12, 64:] = semantics.POLE
    assert mov.any()
    return (disp.astype(np.float16), np.asarray(img, np.float16),
            sem.astype(np.int32), mov, planted)


def _fuse_cases():
    """(semantic mask, U-V mask, area threshold, pixels of the fused mask)
    of the motion-overlay cases. Components: a band at each side edge (384
    px each), a 1200 px block, a 560 px block on the bottom edge."""
    sem = np.zeros((H, W), bool)
    sem[:, :6] = sem[:, -6:] = True
    sem[10:40, 30:70] = True
    sem[50:64, 80:120] = True
    uv_block = np.zeros((H, W), bool)
    uv_block[10:40, 30:50] = True            # half of the 1200 px block
    uv_none = np.zeros((H, W), bool)
    uv_none[0:2, 90:100] = True
    uv_bottom = np.zeros((H, W), bool)
    uv_bottom[10:12, 30:40] = True           # 20 of the 1200 px block
    uv_bottom[50:64, 80:120] = True          # all of the 560 px block
    uv_band = uv_block.copy()
    uv_band[:, :6] = True
    return [(sem, uv_block, 500, 1200),      # one component passes
            (sem, uv_none, 500, 2528),       # none passes: the mask stays
            (sem, uv_bottom, 500, 560),      # the large one fails its
            (sem, uv_band, 300, 1584)]       # overlay; two pass


def test_kf_cloud_and_fuse_match_jax():
    disp, left, sem, mov, planted = _keyframe()
    assert len(planted) > 20
    for stride in (1, 2):
        jcfg = JMapperConfig(cloud_stride=stride)
        tcfg = MapperConfig(cloud_stride=stride)
        j = _kf_cloud_jit(jnp.asarray(disp), jnp.asarray(left), None,
                          jnp.asarray(sem), jnp.asarray(mov), JK_, CAM, jcfg,
                          jcfg.max_points_per_frame)
        t = _kf_cloud(torch.from_numpy(disp), torch.from_numpy(left), None,
                      torch.from_numpy(sem).long(), torch.from_numpy(mov),
                      TK, tcfg)
        n = int(j[3])
        assert n > 500 and int(t[3]) == n, (stride, n, int(t[3]))
        for a, b in zip(j[:3], t[:3]):
            assert np.array_equal(np.asarray(a)[:n], b.numpy()[:n]), stride
        lbl = t[2].numpy()[:n]
        assert not np.isin(lbl, semantics.MAP_EXCLUDED_CLASSES).any()
        assert not (lbl == semantics.PEDESTRIAN).any()

    # uint8 color and float color: the same cloud as JAX's
    rgb = np.stack([left.astype(np.float32)] * 3, -1) * [1.0, 0.8, 0.6]
    u8 = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    for color in (u8, u8.astype(np.float32) / 255.0):
        j = _kf_cloud_jit(jnp.asarray(disp), jnp.asarray(left),
                          jnp.asarray(color), jnp.asarray(sem), None, JK_,
                          CAM, JMapperConfig(), 1 << 17)
        t = _kf_cloud(torch.from_numpy(disp), torch.from_numpy(left),
                      torch.from_numpy(color), torch.from_numpy(sem).long(),
                      None, TK, MapperConfig())
        n = int(j[3])
        assert int(t[3]) == n
        for a, b in zip(j[:3], t[:3]):
            assert np.array_equal(np.asarray(a)[:n], b.numpy()[:n])

    for sem_m, uv, area, expected in _fuse_cases():
        jc = dataclasses.replace(JMapperConfig(), motion_area_threshold=area)
        tc = dataclasses.replace(MapperConfig(), motion_area_threshold=area)
        a = np.asarray(jmp.motion_overlay_fuse(jnp.asarray(sem_m),
                                               jnp.asarray(uv), jc))
        b = tmp_.motion_overlay_fuse(torch.from_numpy(sem_m),
                                     torch.from_numpy(uv), tc).numpy()
        assert np.array_equal(a, b) and int(b.sum()) == expected


def _map_inputs(rng):
    """Four inserts of points clustered so that voxels collect several
    points, with labels and valid masks."""
    out = []
    for i in range(4):
        n = 3000
        centers = rng.integers(-30, 30, size=(n // 6, 3)) * 0.1 + 0.05
        xyz = (np.repeat(centers, 6, axis=0)
               + rng.uniform(-0.045, 0.045, (n, 3))).astype(np.float32)
        rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        lbl = rng.integers(0, 12, n).astype(np.int32)
        valid = rng.uniform(size=n) < 0.9
        out.append((xyz, rgb, lbl, valid if i % 2 else None))
    return out


def _sorted(xyz, rgb, lbl, res=0.1):
    key = np.floor(xyz / res).astype(np.int64)
    order = np.lexsort(key.T[::-1])
    return key[order], xyz[order], rgb[order], lbl[order]


def test_voxel_maps_and_pcd_match_jax(tmp_path):
    inserts = _map_inputs(np.random.default_rng(0))
    jmap = jmp.GlobalMap(JMapperConfig())
    tmap = tmp_.GlobalMap(MapperConfig())
    nmap = NativeVoxelMap(0.1)
    for xyz, rgb, lbl, valid in inserts:
        for m in (jmap, tmap, nmap):
            m.insert(xyz, rgb, lbl, valid)
    assert len(jmap) == len(tmap) == len(nmap) > 1000
    ja, ta = jmap.as_arrays(), tmap.as_arrays()
    for a, b in zip(ja, ta):
        assert np.array_equal(a, b)
    ks, jx, jr, jl = _sorted(*ja)
    kn, nx, nr, nl = _sorted(*nmap.as_arrays())
    assert np.array_equal(ks, kn)
    np.testing.assert_allclose(nx, jx, atol=2e-5)
    np.testing.assert_allclose(nr, jr, atol=2e-5)
    assert np.array_equal(nl, jl)
    assert nmap.updates == tmap.updates == 4

    # a FrameCloud insert (tensors) equals the array insert
    xyz, rgb, lbl, _ = inserts[0]
    valid = np.arange(len(xyz)) < 2000
    cloud = tmp_.FrameCloud(*(torch.from_numpy(a) for a in
                              (xyz, rgb, lbl, valid)))
    jc = jmp.GlobalMap(JMapperConfig())
    jc.insert(xyz, rgb, lbl, valid)
    tc = tmp_.GlobalMap(MapperConfig())
    tc.insert_cloud(cloud)
    nc = NativeVoxelMap(0.1)
    nc.insert_cloud(cloud)
    assert len(tc) == len(nc) == len(jc)
    assert np.array_equal(jc.as_arrays()[0], tc.as_arrays()[0])

    for binary in (True, False):
        pj, pt = tmp_path / "j.pcd", tmp_path / "t.pcd"
        jmp.write_pcd(str(pj), jx, jr, binary=binary)
        tmp_.write_pcd(str(pt), jx, jr, binary=binary)
        assert pj.read_bytes() == pt.read_bytes()
        jmap.save_pcd(str(pj), binary=binary)
        tmap.save_pcd(str(pt), binary=binary)
        assert pj.read_bytes() == pt.read_bytes()
    pn = tmp_path / "n.pcd"
    nmap.save_pcd(str(pn))
    head = pn.read_bytes()[:300].split(b"DATA binary\n")[0].decode()
    assert f"POINTS {len(nmap)}\n" in head
    assert pn.stat().st_size == len(head) + len(b"DATA binary\n") \
        + 16 * len(nmap)
