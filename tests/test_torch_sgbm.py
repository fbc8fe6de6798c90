"""Parity of the port's SGM aggregation and SGBM with the JAX package.

``sgm_aggregate4_plain`` (the CPU path and the CUDA kernel's oracle) runs
the exact recurrence, as the Pallas kernel does; it is held to
``sgbm._sgm_scan_bidir`` on the volume plus its transpose, and to
``sgm_pallas.sgm_bidir_pallas`` in interpret mode, in float32 and exactly:
the same operations summed in the same order (the bfloat16 contract is
held in test_torch_sgm_contract.py). ``sgbm.compute`` runs with
``cost_dtype="float32"`` at S <= 192 on both axes, where the JAX CPU path
is the exact scan (not the blocked-halo approximation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu.config import SgbmConfig as JSgbm
from semantic_slam_mapping_tpu.ops import sgbm as jsgbm
from semantic_slam_mapping_tpu.ops.pallas import sgm_pallas
from semantic_slam_mapping_torch.config import SgbmConfig as TSgbm
from semantic_slam_mapping_torch.ops import image as tim
from semantic_slam_mapping_torch.ops import sgbm as tsgbm
from semantic_slam_mapping_torch.ops.cuda import sgm_cuda

torch.set_num_threads(2)
SMALL = dict(num_disparities=16, sad_window_size=5, p1=8 * 25, p2=32 * 25,
             speckle_window_size=20, cost_dtype="float32")


def _jax_aggregate4(cost, p1, p2):
    vert = jsgbm._sgm_scan_bidir(jnp.asarray(cost), p1, p2)
    horz = jsgbm._sgm_scan_bidir(jnp.asarray(np.swapaxes(cost, 0, 1)), p1, p2)
    return np.asarray(vert) + np.swapaxes(np.asarray(horz), 0, 1)


def test_plain_aggregate_matches_jax():
    rng = np.random.default_rng(0)
    for shape, p1, p2 in (((37, 24, 16), 7.0, 50.0),
                          ((20, 33, 80), 60.5, 242.0),
                          ((9, 40, 96), 1.0, 3.0)):
        cost = rng.uniform(0, 100, shape).astype(np.float32)
        ref = _jax_aggregate4(cost, p1, p2)
        out = sgm_cuda.sgm_aggregate4_plain(torch.from_numpy(cost), p1, p2)
        assert out.dtype == torch.float32 and tuple(out.shape) == shape
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=str(shape))

    # against the Pallas kernel itself, in interpret mode
    cost = rng.uniform(0, 100, (21, 17, 16)).astype(np.float32)
    vert = sgm_pallas.sgm_bidir_pallas(jnp.asarray(cost), 7.0, 50.0,
                                       interpret=True)
    horz = sgm_pallas.sgm_bidir_pallas(
        jnp.asarray(np.swapaxes(cost, 0, 1)), 7.0, 50.0, interpret=True)
    ref = np.asarray(vert) + np.swapaxes(np.asarray(horz), 0, 1)
    out = sgm_cuda.sgm_aggregate4_plain(torch.from_numpy(cost), 7.0, 50.0)
    np.testing.assert_array_equal(out.numpy(), ref)

    # the wrapper runs the plain version on a CPU tensor and launches nothing
    cost = torch.from_numpy(rng.uniform(0, 50, (12, 10, 8)).astype(
        np.float32))
    before = sgm_cuda.sgm_aggregate4.launches
    out = sgm_cuda.sgm_aggregate4(cost, 5.0, 20.0)
    assert sgm_cuda.sgm_aggregate4.launches == before
    torch.testing.assert_close(out, sgm_cuda.sgm_aggregate4_plain(
        cost, 5.0, 20.0), rtol=0, atol=0)
    assert sgm_cuda.sgm_aggregate4(cost.bfloat16(), 5.0, 20.0).dtype == \
        torch.bfloat16

    with pytest.raises(NotImplementedError):
        tsgbm._aggregate(torch.zeros((4, 4, 8)), TSgbm(full_dp=True))


@pytest.fixture(scope="module")
def stereo_pair():
    """A textured 96x192 pair with a 4 px shift, made with numpy."""
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 1, (96, 220)).astype(np.float32)
    base = tim.gaussian_blur(torch.from_numpy(base), 1.0).numpy()
    return base[:, 10:202].copy(), base[:, 14:206].copy()


@pytest.fixture(scope="module")
def jax_sgbm(stereo_pair):
    left, right = stereo_pair
    cfg = JSgbm(**SMALL)
    vol = jsgbm._cost_volume(jnp.asarray(left), jnp.asarray(right), cfg)
    res = jsgbm.compute(jnp.asarray(left), jnp.asarray(right), cfg)
    return np.asarray(vol), jax.tree.map(np.asarray, res)


def test_sgbm_compute_matches_jax(stereo_pair, jax_sgbm):
    left, right = stereo_pair
    vol = tsgbm._cost_volume(torch.from_numpy(left), torch.from_numpy(right),
                             TSgbm(**SMALL))
    assert vol.is_contiguous()
    np.testing.assert_allclose(vol.numpy(), jax_sgbm[0], atol=1e-4)

    ref = jax_sgbm[1]
    out = tsgbm.compute(torch.from_numpy(left), torch.from_numpy(right),
                        TSgbm(**SMALL))
    # the validity masks agree except where float rounding tips a gate
    agree = (out.valid.numpy() == ref.valid).mean()
    assert agree > 0.999, agree
    assert ref.valid.mean() > 0.5
    both = out.valid.numpy() & ref.valid
    np.testing.assert_allclose(out.disparity.numpy()[both],
                               ref.disparity[both], atol=1e-3)
