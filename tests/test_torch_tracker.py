"""The port's tracker pieces outside one step: the constant-velocity flow
prior (against JAX, tolerance 1e-4 px), a JAX tracker state carried across
by ``utils/convert.py`` (exact), the relocalisation rewrites, and the rule
that entry points need a card unless the caller asks for the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import tracker as jtracker
from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_torch import config as tcfg
from semantic_slam_mapping_torch.frontend import tracker as ttracker
from semantic_slam_mapping_torch.geometry import se3 as tse3
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils import convert
from torch_parity_scene import JCAM, JK_, TCFG, TK, to_np

torch.set_num_threads(2)
XI = (0.05, -0.02, 0.8, 0.01, 0.03, -0.005)


def test_velocity_flow_prior_matches_jax():
    jc = jcfg.SlamConfig(camera=JCAM)
    for xi in ((0.0,) * 6, XI):
        a = jtracker._velocity_flow_prior(jse3.exp(jnp.float32(xi)), JK_, jc)
        b = ttracker._velocity_flow_prior(tse3.exp(torch.tensor(xi)), TK,
                                          TCFG)
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-4,
                                   err_msg=str(xi))


def test_tracker_state_carried_across_and_rewritten():
    js = jtracker.TrackerState.initial(jcfg.SlamConfig())
    js = js._replace(pose=jse3.exp(jnp.float32(XI)),
                     frame_index=jnp.int32(7))
    st = convert.tracker_state_from_numpy(
        np.asarray(js.status), np.asarray(js.pose), np.asarray(js.velocity),
        np.asarray(js.lost_count),
        (np.asarray(js.pitch_kf.x), np.asarray(js.pitch_kf.P)),
        np.asarray(js.frame_index), device="cpu")
    np.testing.assert_array_equal(to_np(st.pose), np.asarray(js.pose))
    assert st.status.dtype == torch.int32 and int(st.frame_index) == 7

    new_pose = np.array(jse3.exp(jnp.float32((1.0, 2.0, 3.0, 0.1, 0.0,
                                               0.0))))
    moved = ttracker.adjust(st, torch.from_numpy(new_pose))
    jmoved = jtracker.adjust(js, jnp.asarray(new_pose))
    np.testing.assert_allclose(to_np(moved.pose), np.asarray(jmoved.pose),
                               atol=1e-5)
    assert int(moved.status) == int(jmoved.status) == ttracker.OK
    lost = st._replace(status=torch.tensor(ttracker.LOST, dtype=torch.int32))
    assert int(ttracker.lost_recover(lost, torch.eye(4)).status) == \
        ttracker.OK

    cfg = tcfg.SlamConfig()
    if torch.cuda.is_available():
        assert SlamSystem(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SlamSystem(cfg)
    assert SlamSystem(cfg, device="cpu").device.type == "cpu"
