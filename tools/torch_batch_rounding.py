"""Where a batch of frame pairs rounds otherwise than each pair alone, on
the card.

On frames of chip_smoke.py's window street (376x1241), one current frame
against five earlier ones (the loop re-measure's shape: n candidates of
one keyframe), with per-pair flow priors: ``quad_match`` on the batch
against each pair alone, and ``estimate_motion`` on the batch, with
``pairwise`` off and on, against each pair alone with the same samples.
Then the pieces of ``vo._gn_refine`` on random inputs: the normal
equations (two einsums), the 6x6 solve, the point transform and the pose
update, over 3 groups of 200 problems against 3 x 200 and over 3 problems
against 3 x 1. Prints one JSON line of largest absolute differences.

    python3 tools/torch_batch_rounding.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from semantic_slam_mapping_torch.config import SlamConfig  # noqa: E402
from semantic_slam_mapping_torch.frontend import quadmatch, vo  # noqa: E402
from semantic_slam_mapping_torch.geometry import se3  # noqa: E402
from semantic_slam_mapping_torch.geometry.camera import Intrinsics  # noqa: E402
from semantic_slam_mapping_torch.pipeline import SlamSystem  # noqa: E402


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def pairs(cfg, K, out: dict) -> None:
    lefts, rights, _, _ = chip_smoke.render_street(
        cfg, 8, chip_smoke.H, chip_smoke.W_KITTI, "cuda")
    up = SlamSystem(cfg, device="cuda")._upload_window
    L, R = up(lefts), up(rights)
    earlier = [0, 1, 2, 3, 5]
    n = len(earlier)
    fp = torch.tensor([[3.0, 1.0], [6.0, -2.0], [9.0, 0.5], [0.0, 0.0],
                       [-4.0, 1.0]], device="cuda")
    qm = dict(qcfg=cfg.quadmatch, gcfg=cfg.gftt, kcfg=cfg.klt)
    mb = quadmatch.quad_match(
        cur_left=L[4].expand(n, -1, -1), cur_right=R[4].expand(n, -1, -1),
        prev_left=L[earlier], prev_right=R[earlier], flow_prior=fp, **qm)
    ms = [quadmatch.quad_match(cur_left=L[4], cur_right=R[4],
                               prev_left=L[e], prev_right=R[e],
                               flow_prior=fp[i], **qm)
          for i, e in enumerate(earlier)]
    out["quad_match"] = max(max_abs(a[i], b) for i in range(n)
                            for a, b in zip(mb, ms[i]))
    out["valid_matches"] = mb.valid.sum(-1).tolist()
    gen = torch.Generator(device="cuda").manual_seed(0)
    picks = torch.stack([vo._distinct3(gen, mb.valid[i].sum(),
                                       cfg.vo.ransac_iters)
                         for i in range(n)])
    single = [vo.estimate_motion(vo.QuadMatches(*(x[i] for x in mb)), K,
                                 None, cfg.vo, picks=picks[i])
              for i in range(n)]
    for pairwise in (False, True):
        rb = vo.estimate_motion(mb, K, None, cfg.vo, picks=picks,
                                pairwise=pairwise)
        key = "pairwise" if pairwise else "batched"
        out[f"estimate_motion {key}: T"] = max(
            max_abs(rb.T_delta[i], single[i].T_delta) for i in range(n))
        out[f"estimate_motion {key}: inliers equal"] = all(
            torch.equal(rb.inliers[i], single[i].inliers) for i in range(n))


def pieces(out: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    N = 512
    for name, (b, groups) in {"3x200": (200, 3), "3x1": (1, 3)}.items():
        B = b * groups
        Jw, J, r = rand(B, N, 4, 6), rand(B, N, 4, 6), rand(B, N, 4)
        T = se3.exp(rand(B, 6, scale=0.1))
        X = rand(B, N, 3) + 10.0

        def split(fn, *xs):
            return torch.cat([fn(*(x[i * b:(i + 1) * b] for x in xs))
                              for i in range(groups)])

        ops = {
            "einsum H": lambda a, c: torch.einsum("bnri,bnrj->bij", a, c),
            "einsum g": lambda a, c: torch.einsum("bnri,bnr->bi", a, c),
        }
        args = {"einsum H": (Jw, J), "einsum g": (Jw, r)}
        for op, fn in ops.items():
            out[f"{name} {op}"] = max_abs(fn(*args[op]), split(fn, *args[op]))
        H = ops["einsum H"](Jw, J) + 100.0 * torch.eye(6, device="cuda")
        g = ops["einsum g"](Jw, r)

        def solve(h, v):
            return torch.linalg.solve_ex(h, v)[0]

        out[f"{name} solve"] = max_abs(solve(H, g), split(solve, H, g))
        out[f"{name} transform"] = max_abs(se3.transform_points(T, X),
                                           split(se3.transform_points, T, X))
        d = rand(B, 6, scale=0.01)

        def update(dd, t):
            return se3.exp(dd) @ t

        out[f"{name} pose update"] = max_abs(update(d, T), split(update, d, T))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_batch_rounding needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SlamConfig()
    out = {"card": chip_smoke.nvidia_smi()}
    pairs(cfg, Intrinsics.from_config(cfg.camera), out)
    pieces(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
