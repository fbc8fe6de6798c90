"""The SGM aggregate's contract against the Pallas kernel, bit for bit.

The TPU path (``ops/sgbm.py::_aggregate`` with ``use_pallas``) rounds each
directional pair of ``sgm_pallas.sgm_bidir_pallas`` to the volume's dtype
and sums the vertical and the swapped horizontal pair in that dtype. The
port's ``sgm_aggregate4_plain`` (the CPU path and the CUDA kernel's oracle)
must return the same bits, in bfloat16 and in float32, and ``sgbm.compute``
with the default bfloat16 volume must then give the JAX TPU path's
disparities and valid mask exactly. The Pallas kernel runs in interpret
mode, as the JAX package's own tests run it on the CPU.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.config import SgbmConfig as JSgbm
from semantic_slam_mapping_tpu.ops import sgbm as jsgbm
from semantic_slam_mapping_tpu.ops.pallas import sgm_pallas
from semantic_slam_mapping_torch.config import SgbmConfig as TSgbm
from semantic_slam_mapping_torch.ops import sgbm as tsgbm
from semantic_slam_mapping_torch.ops.cuda import sgm_cuda

from torch_parity_scene import street_frames

torch.set_num_threads(2)
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}


def _pallas_aggregate4(vol, p1, p2):
    """ops/sgbm.py:260-261 on the TPU path, with the kernel interpreted."""
    volT = jnp.swapaxes(vol, 0, 1)
    return sgm_pallas.sgm_bidir_pallas(vol, p1, p2, interpret=True) \
        + jnp.swapaxes(sgm_pallas.sgm_bidir_pallas(volT, p1, p2,
                                                   interpret=True), 0, 1)


def test_plain_aggregate_is_the_pallas_contract():
    rng = np.random.default_rng(11)
    # (1, 7): one odd-length line, and lines of a single step the other way
    cases = (((37, 24, 16), 7.0, 50.0), ((24, 37, 16), 60.5, 242.0),
             ((1, 7, 16), 7.0, 50.0))
    for (dtype, (tdt, jdt)), (shape, p1, p2) in itertools.product(
            DTYPES.items(), cases):
        vol = torch.from_numpy(rng.uniform(0, 100, shape).astype(
            np.float32)).to(tdt)
        ref = _pallas_aggregate4(jnp.asarray(vol.float().numpy()).astype(jdt),
                                 p1, p2)
        assert ref.dtype == jdt
        out = sgm_cuda.sgm_aggregate4_plain(vol, p1, p2)
        assert out.dtype == tdt and tuple(out.shape) == shape
        np.testing.assert_array_equal(
            out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
            err_msg=f"{shape} {dtype}")
        # the wrapper takes the plain version for a CPU tensor
        before = sgm_cuda.sgm_aggregate4.launches
        assert torch.equal(sgm_cuda.sgm_aggregate4(vol, p1, p2), out)
        assert sgm_cuda.sgm_aggregate4.launches == before


def test_sgbm_compute_default_bf16_is_the_tpu_path():
    seq = street_frames()
    left, right = seq["left"][0], seq["right"][0]
    small = dict(num_disparities=32, sad_window_size=5, p1=8 * 25,
                 p2=32 * 25, speckle_window_size=20)
    jcfg, tcfg = JSgbm(**small), TSgbm(**small)
    assert jcfg.cost_dtype == tcfg.cost_dtype == "bfloat16"

    # the JAX TPU path of sgbm.compute, composed by hand. The cost volume
    # runs op by op: under jit, XLA on the CPU keeps some bfloat16
    # intermediates in float32 and the volume moves by a rounding step
    p1, p2 = float(jcfg.p1) / 16.0, float(jcfg.p2) / 16.0
    jvol = jsgbm._cost_volume(jnp.asarray(left), jnp.asarray(right), jcfg)
    jagg = _pallas_aggregate4(jvol, p1, p2)

    @jax.jit
    def select(agg):
        disp, unique_ok = jsgbm._wta_subpixel(agg, jcfg)
        lr_ok = jsgbm._lr_check(agg, disp, jcfg)
        valid = unique_ok & lr_ok & (disp > jcfg.min_disparity)
        valid = jsgbm._speckle_filter(disp, valid, jcfg)
        return jnp.where(valid, disp, jsgbm.INVALID), valid

    disp, valid = map(np.asarray, select(jagg))

    tvol = tsgbm._cost_volume(torch.from_numpy(left),
                              torch.from_numpy(right), tcfg)
    np.testing.assert_array_equal(tvol.float().numpy(),
                                  np.asarray(jvol.astype(jnp.float32)))
    tagg = tsgbm._aggregate(tvol, tcfg)
    assert tagg.dtype == torch.bfloat16
    np.testing.assert_array_equal(tagg.float().numpy(),
                                  np.asarray(jagg.astype(jnp.float32)))

    out = tsgbm.compute(torch.from_numpy(left), torch.from_numpy(right), tcfg)
    assert valid.mean() > 0.5
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    np.testing.assert_array_equal(out.disparity.numpy(), disp)
