"""The SGM aggregate of a batch of frames, and the 8-direction (full_dp)
aggregate, against the JAX package's TPU path, bit for bit.

On the TPU the JAX window runs ``sgm_bidir_pallas`` under ``vmap`` (a batch
grid axis); the port's ``sgm_aggregate4_plain`` takes the (B, H, W, D)
batch at once and must return the same bits, in bfloat16 and in float32,
and what B single calls return. With ``full_dp`` the TPU path adds the
four diagonal paths of ``_diag_paths_full`` (a scan in the volume's dtype)
to the Pallas pair sums; the port's ``sgbm._aggregate`` must equal that
composition bit for bit, and the textbook per-pixel recurrence of
test_sgbm.py within its tolerance (rtol 1e-5, atol 1e-2). The Pallas kernel
runs in interpret mode, as the JAX package's own tests run it on the CPU.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.ops import sgbm as jsgbm
from semantic_slam_mapping_tpu.ops.pallas import sgm_pallas
from semantic_slam_mapping_torch.config import SgbmConfig as TSgbm
from semantic_slam_mapping_torch.ops import sgbm as tsgbm
from semantic_slam_mapping_torch.ops.cuda import sgm_cuda

from test_sgbm import _sgm_numpy_8dir

torch.set_num_threads(2)
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}


def _pallas_aggregate4(vol, p1, p2):
    """ops/sgbm.py:260-261 on the TPU path for one (H, W, D) volume, with
    the kernel interpreted."""
    volT = jnp.swapaxes(vol, 0, 1)
    return sgm_pallas.sgm_bidir_pallas(vol, p1, p2, interpret=True) \
        + jnp.swapaxes(sgm_pallas.sgm_bidir_pallas(volT, p1, p2,
                                                   interpret=True), 0, 1)


def _as_np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


def test_batched_plain_aggregate_is_the_vmapped_pallas_contract():
    rng = np.random.default_rng(3)
    # a ragged batch: odd line lengths and a disparity count that is not a
    # whole number of 16-byte vectors
    cases = (((3, 13, 17, 11), 7.0, 50.0), ((2, 9, 6, 16), 60.5, 242.0))
    for (dtype, (tdt, jdt)), (shape, p1, p2) in itertools.product(
            DTYPES.items(), cases):
        vol = torch.from_numpy(rng.uniform(0, 100, shape).astype(
            np.float32)).to(tdt)
        jvol = jnp.asarray(vol.float().numpy()).astype(jdt)
        ref = jax.vmap(lambda v: _pallas_aggregate4(v, p1, p2))(jvol)
        assert ref.dtype == jdt
        out = sgm_cuda.sgm_aggregate4_plain(vol, p1, p2)
        assert out.dtype == tdt and tuple(out.shape) == shape
        np.testing.assert_array_equal(_as_np(out), _as_np(ref),
                                      err_msg=f"{shape} {dtype}")
        singles = torch.stack([sgm_cuda.sgm_aggregate4_plain(v, p1, p2)
                               for v in vol])
        assert torch.equal(out, singles), (shape, dtype)
        # the wrapper takes the plain version for a CPU tensor
        before = sgm_cuda.sgm_aggregate4.launches
        assert torch.equal(sgm_cuda.sgm_aggregate4(vol, p1, p2), out)
        assert sgm_cuda.sgm_aggregate4.launches == before


def test_full_dp_aggregate_is_the_tpu_path():
    rng = np.random.default_rng(9)
    small = dict(num_disparities=8, sad_window_size=5, p1=8 * 25,
                 p2=32 * 25, full_dp=True)
    for dtype, (tdt, jdt) in DTYPES.items():
        tcfg = TSgbm(cost_dtype=dtype, **small)
        p1, p2 = float(tcfg.p1) / 16.0, float(tcfg.p2) / 16.0
        vols = rng.uniform(0, 100, (2, 18, 22, 8)).astype(np.float32)
        tvol = torch.from_numpy(vols).to(tdt)
        jvol = jnp.asarray(vols).astype(jdt)
        # ops/sgbm.py:258-264, the TPU path with fullDP
        ref = jax.vmap(lambda v: _pallas_aggregate4(v, p1, p2)
                       + jsgbm._diag_paths_full(v, p1, p2))(jvol)
        assert ref.dtype == jdt
        got = tsgbm._aggregate(tvol, tcfg)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_as_np(got), _as_np(ref),
                                      err_msg=dtype)
        # a batch gives what each frame gives alone
        for b in range(2):
            assert torch.equal(tsgbm._aggregate(tvol[b], tcfg), got[b])
        if dtype == "float32":
            want = _sgm_numpy_8dir(
                vols[0], p1, p2,
                [(1, 0), (-1, 0), (0, 1), (0, -1),
                 (1, 1), (-1, 1), (1, -1), (-1, -1)])
            np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5,
                                       atol=1e-2)
    # and the whole of sgbm.compute runs with it, per frame as batched
    left = torch.from_numpy(rng.uniform(0, 1, (2, 24, 40)).astype(
        np.float32))
    right = torch.roll(left, -3, dims=-1)
    cfg = dataclasses.replace(TSgbm(**small), speckle_window_size=4)
    out = tsgbm.compute(left, right, cfg)
    for b in range(2):
        one = tsgbm.compute(left[b], right[b], cfg)
        assert torch.equal(one.disparity, out.disparity[b])
        assert torch.equal(one.valid, out.valid[b])
    assert out.valid.float().mean() > 0.3
