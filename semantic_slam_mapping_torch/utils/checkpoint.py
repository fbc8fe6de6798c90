"""Checkpoint and resume of the whole SLAM state.

Counterpart of ``semantic_slam_mapping_tpu/utils/checkpoint.py``, with the
same npz keys and dtypes: the keyframe database (poses, BoW, features,
float16 images, color and labels for the map), the pose graph, the tracker
state and the trajectory go into one compressed npz, and a checkpoint
written by either package loads in the other. The configuration and the
vocabulary are not state: the caller passes them to :func:`load_slam`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from semantic_slam_mapping_torch.backend import looper as lp
from semantic_slam_mapping_torch.backend import pose_graph as pg
from semantic_slam_mapping_torch.utils import convert


def save_slam(path: str | Path, system) -> None:
    """Write a ``pipeline.SlamSystem`` after draining its deferred work."""
    system._drain_all()
    st = system.state
    graph = system.graph
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    data = dict(
        n_keyframes=np.int64(len(system.keyframes)),
        n_edges=np.int64(system.n_edges),
        frame_count=np.int64(system.frame_count),
        local_error=np.float64(system.local_error),
        loop_error=np.float64(system.loop_error),
        trajectory=(np.stack(system.trajectory) if system.trajectory
                    else np.zeros((0, 4, 4))),
        graph_poses=graph.poses,
        graph_vertex_valid=graph.vertex_valid,
        graph_edge_i=graph.edge_i.astype(np.int32),
        graph_edge_j=graph.edge_j.astype(np.int32),
        graph_edge_T=graph.edge_T,
        graph_edge_info=graph.edge_info,
        graph_edge_valid=graph.edge_valid,
        graph_edge_is_loop=graph.edge_is_loop,
        tracker_status=host(st.status),
        tracker_pose=host(st.pose),
        tracker_velocity=host(st.velocity),
        tracker_lost=host(st.lost_count),
        tracker_kf_x=host(st.pitch_kf.x),
        tracker_kf_P=host(st.pitch_kf.P),
        tracker_frame_index=host(st.frame_index),
    )
    for i, kf in enumerate(system.keyframes):
        p = f"kf{i}_"
        data[p + "pose"] = kf.pose
        data[p + "frame_index"] = np.int64(kf.frame_index)
        data[p + "feat_xy"] = kf.feat_xy
        data[p + "feat_desc"] = kf.feat_desc
        data[p + "feat_xyz"] = kf.feat_xyz
        data[p + "feat_valid"] = kf.feat_valid
        data[p + "left"] = kf.left
        if kf.right is not None:
            data[p + "right"] = kf.right
        if kf.bow_idx is not None:
            data[p + "bow_idx"] = kf.bow_idx.astype(np.int32)
            data[p + "bow_w"] = kf.bow_w
        if kf.disparity is not None:
            data[p + "disparity"] = kf.disparity
        # the map's inputs, so that a resumed run keeps mapping
        if kf.color is not None:
            data[p + "color"] = kf.color
        if kf.semantic is not None:
            data[p + "semantic"] = kf.semantic
    np.savez_compressed(path, **data)


def load_slam(path: str | Path, cfg, vocab: Optional[lp.Vocabulary] = None,
              enable_mapping: bool = False, device: str = "cuda"):
    """A ``pipeline.SlamSystem`` restored from a checkpoint, on ``device``.
    Its keyframes keep their data on the host until a step needs it on the
    device; with ``enable_mapping`` the next map update maps the restored
    keyframes of its window from their stored images and labels."""
    from semantic_slam_mapping_torch.pipeline import Keyframe, SlamSystem

    z = np.load(path, allow_pickle=False)
    system = SlamSystem(cfg, vocab=vocab, enable_mapping=enable_mapping,
                        device=device)
    system.n_edges = int(z["n_edges"])
    system.frame_count = int(z["frame_count"])
    system.local_error = float(z["local_error"])
    system.loop_error = float(z["loop_error"])
    system.trajectory = list(z["trajectory"])
    system.graph = pg.PoseGraph(
        poses=np.array(z["graph_poses"], np.float32),
        vertex_valid=np.array(z["graph_vertex_valid"]),
        edge_i=np.array(z["graph_edge_i"], np.int64),
        edge_j=np.array(z["graph_edge_j"], np.int64),
        edge_T=np.array(z["graph_edge_T"], np.float32),
        edge_info=np.array(z["graph_edge_info"], np.float32),
        edge_valid=np.array(z["graph_edge_valid"]),
        edge_is_loop=np.array(z["graph_edge_is_loop"]))
    system.state = convert.tracker_state_from_numpy(
        z["tracker_status"], z["tracker_pose"], z["tracker_velocity"],
        z["tracker_lost"], (z["tracker_kf_x"], z["tracker_kf_P"]),
        z["tracker_frame_index"], device=system.device)
    for i in range(int(z["n_keyframes"])):
        p = f"kf{i}_"

        def get(k, dtype=None):
            if p + k not in z:
                return None
            return z[p + k] if dtype is None else z[p + k].astype(dtype)
        system.keyframes.append(Keyframe(
            kf_id=i,
            frame_index=int(z[p + "frame_index"]),
            pose=z[p + "pose"],
            bow_idx_host=get("bow_idx", np.int64),
            bow_w_host=get("bow_w"),
            feat_xy_host=z[p + "feat_xy"],
            feat_desc_host=z[p + "feat_desc"],
            feat_xyz_host=z[p + "feat_xyz"],
            feat_valid_host=z[p + "feat_valid"],
            left_host=z[p + "left"],
            right_host=get("right"),
            disparity_host=get("disparity"),
            color=get("color"),
            semantic_host=get("semantic")))
    # the relocalisation references: the newest keyframes
    for kf in system.keyframes[-system.ref_frames.maxlen:]:
        system.ref_frames.append(kf)
    return system
