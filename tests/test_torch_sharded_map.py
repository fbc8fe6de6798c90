"""The port's slab-sharded voxel map over gloo with 2 and 4 ranks on the CPU
(the rank bodies are in ``torch_mesh_ranks.py``), against the JAX
package's ``parallel/sharded_map.py`` on the conftest mesh's first n
devices, in tests/test_sharded_map.py's setting (budget 4096, 0.2 m
voxels, x_extent 8 m).

Test 1: ``fuse_cloud`` on five clouds with random labels and colours:
one blob per eighth of the extent (every slab gets voxels), random points
fused twice (no duplicate voxel, counts add up), points out of the extent
(none kept), a pair of points across the border of the two middle slabs
and a loner (with min_support 1 the pair survives through the halo, the
loner does not), and a pair across the extent's two ends (they support
each other through the ring's wrap, slab n-1 to slab 0). Each rank's
state, gathered in slab order, equals JAX's (n, budget) state exactly:
keys of the valid entries, valid masks, counts, labels, positions and
colours.

Test 2: ``ShardedGlobalMap`` over the three clouds of
``__graft_entry__.py:162-193`` (budget 4096, 512 points a cloud): its
voxel keys within 1% of the port's host ``GlobalMap`` (first-observation
positions against running means), its length that of its export on every
rank, its PCD read back; ``SlamSystem(mesh=..., enable_mapping=True)``
maps into a ``ShardedGlobalMap`` at the mapper's resolution.
"""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.parallel import mesh as jmesh
from semantic_slam_mapping_tpu.parallel import sharded_map as jsm
from semantic_slam_mapping_torch.config import MapperConfig, SlamConfig
from semantic_slam_mapping_torch.mapping.mapper import GlobalMap

from torch_mesh_ranks import run_ranks

torch.set_num_threads(2)
BUDGET = 1 << 12
RES = 0.2
EXT = 8.0
N_POINTS = 600


def _scenarios(n: int):
    """(xyz, fusions, min_support) of each cloud; every cloud padded to
    N_POINTS with invalid points."""
    rng = np.random.default_rng(0)
    slab_w = 2 * EXT / n
    blobs = np.concatenate([
        np.stack([np.full(50, c), np.linspace(-1, 1, 50), np.zeros(50)], -1)
        for c in np.linspace(-EXT + 1.0, EXT - 1.0, 8)])
    scattered = rng.uniform(-EXT + 0.5, EXT - 0.5, (500, 3)) * \
        np.array([1.0, 0.2, 0.2])
    far = np.array([[100.0, 0.0, 0.0], [0.0, 0.0, 100.0]])
    xb = -EXT + slab_w * (n // 2)
    eps = RES / 4
    border = np.array([[xb - eps, 0.0, 0.0], [xb + eps, 0.0, 0.0],
                       [xb + slab_w / 2, 5.0, 5.0]])
    wrap = np.array([[EXT - eps, 1.0, -1.0], [-EXT + eps, 1.0, -1.0],
                     [0.5 * slab_w, -5.0, 5.0]])
    return [(blobs, 1, 0), (scattered, 2, 0), (far, 1, 0), (border, 1, 1),
            (wrap, 1, 1)]


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(n)
    out = {"budget": BUDGET, "res": RES, "ext": EXT}
    scen = _scenarios(n)
    out["n_scenarios"] = len(scen)
    for i, (xyz, fusions, support) in enumerate(scen):
        k = len(xyz)
        pad = np.zeros((N_POINTS, 3), np.float32)
        pad[:k] = xyz
        out[f"s{i}_xyz"] = pad
        out[f"s{i}_rgb"] = rng.uniform(0, 1, (N_POINTS, 3)).astype(
            np.float32)
        out[f"s{i}_label"] = rng.integers(0, 12, N_POINTS).astype(np.int32)
        out[f"s{i}_valid"] = np.arange(N_POINTS) < k
        out[f"s{i}_fusions"] = fusions
        out[f"s{i}_support"] = support
    return out


def _jax_states(inp: dict, n: int) -> list:
    m = jmesh.make_mesh(n, dp=n, tp=1)
    states = []
    for i in range(inp["n_scenarios"]):
        st = jsm.empty_map(m, BUDGET)
        for _ in range(inp[f"s{i}_fusions"]):
            st = jsm.fuse_cloud(
                st, jnp.asarray(inp[f"s{i}_xyz"]),
                jnp.asarray(inp[f"s{i}_rgb"]),
                jnp.asarray(inp[f"s{i}_valid"]), m, budget=BUDGET,
                resolution=RES, x_extent=EXT,
                min_support=inp[f"s{i}_support"],
                label=jnp.asarray(inp[f"s{i}_label"]))
        states.append({k: np.asarray(v) for k, v in st._asdict().items()})
    return states


def test_fuse_cloud_matches_jax(tmp_path):
    for n in (2, 4):
        inp = _inputs(n)
        np.savez(tmp_path / "inputs.npz", **inp)
        want = _jax_states(inp, n)
        ranks = run_ranks("fuse_scenarios", n, tmp_path)
        # what each scenario must show, on JAX's states
        blobs, scattered, far, border, wrap = (w["valid"] for w in want)
        assert (blobs.sum(axis=1) > 0).all()
        assert scattered.sum() > 100 and not far.any()
        assert border.sum() == 2 and wrap.sum() == 2
        assert wrap[0].sum() == wrap[n - 1].sum() == 1
        # fused twice: each of the 500 points counted twice, in fewer
        # voxels than points
        assert want[1]["count"].sum() == 1000 and scattered.sum() < 500
        for r, out in enumerate(ranks):
            for i, w in enumerate(want):
                v = w["valid"]
                assert out[f"s{i}_local_valid"] == v[r].sum()
                np.testing.assert_array_equal(out[f"s{i}_valid"], v)
                np.testing.assert_array_equal(out[f"s{i}_keys"][v],
                                              w["keys"][v].astype(np.int64))
                for f in ("count", "label", "xyz", "rgb"):
                    np.testing.assert_array_equal(out[f"s{i}_{f}"], w[f],
                                                  err_msg=f"{i} {f}")


def test_sharded_global_map_matches_host_map(tmp_path):
    rng = np.random.default_rng(0)
    inp = {"res": RES, "n_clouds": 3, "pcd_dir": str(tmp_path)}
    host = GlobalMap(MapperConfig(resolution=RES))
    for i in range(3):
        xyz = (rng.uniform(-6.0, 6.0, (400, 3))
               * np.array([1.0, 0.3, 0.3])).astype(np.float32)
        rgb = rng.uniform(0, 1, (400, 3)).astype(np.float32)
        lbl = rng.integers(0, 12, 400).astype(np.int32)
        inp.update({f"xyz{i}": xyz, f"rgb{i}": rgb, f"label{i}": lbl})
        host.insert(xyz, rgb, lbl)
    np.savez(tmp_path / "inputs.npz", **inp)
    gkeys = set(map(tuple, np.floor(host.as_arrays()[0] / RES).astype(
        np.int64).tolist()))
    assert len(gkeys) > 100
    for n in (2, 4):
        ranks = run_ranks("sharded_global_map", n, tmp_path)
        for out in ranks:
            skeys = set(map(tuple, np.floor(out["xyz"] / RES).astype(
                np.int64).tolist()))
            assert len(skeys ^ gkeys) <= 0.01 * len(gkeys)
            assert out["len"] == len(out["xyz"]) == len(ranks[0]["xyz"])
            np.testing.assert_array_equal(out["xyz"], ranks[0]["xyz"])
            assert bool(out["system_map_sharded"])
            assert out["system_map_resolution"] == \
                SlamConfig().mapper.resolution
        pcd = (tmp_path / "map.pcd").read_bytes()
        assert f"POINTS {len(ranks[0]['xyz'])}\n".encode() in pcd
