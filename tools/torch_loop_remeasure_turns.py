"""chip_smoke.py's epoch phase with three loop re-measures, in turns on
one card, each in a process of its own.

- ``pairwise``: the port as it is, every candidate in one batched call
  with each candidate's normal equations solved in calls of its own;
- ``batched``: the same call with ``pairwise=False``, every candidate's
  products in one cuBLAS call;
- ``per_candidate``: quad matching and VO called once a candidate, as
  before the re-measure was batched.

Prints, for each, one JSON line: keyframes, edges, loop edges, ATE,
frames/s, the re-measure's milliseconds a dispatch and the loop
verification log.

    python3 tools/torch_loop_remeasure_turns.py [--order pairwise,batched,per_candidate]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = """
import json, sys, torch
sys.path.insert(0, %r)
import chip_smoke as c
from semantic_slam_mapping_torch import pipeline
from semantic_slam_mapping_torch.frontend import quadmatch, vo
""" % str(ROOT)

VARIANTS = {
    "pairwise": "",
    "batched": """
def batched_vo(self, m):
    n_valid = m.valid.sum(dim=-1)
    picks = torch.stack([vo._distinct3(self.generator, n_valid[i],
                                       self.cfg.vo.ransac_iters)
                         for i in range(n_valid.shape[0])])
    return vo.estimate_motion(m, self.K, None, self.cfg.vo, picks=picks)
pipeline.SlamSystem._loop_vo = batched_vo
""",
    "per_candidate": """
qm = quadmatch.quad_match
def per_candidate_qm(cur_left, cur_right, prev_left, prev_right, *a,
                     flow_prior=None, **k):
    if cur_left.dim() == 2:
        return qm(cur_left, cur_right, prev_left, prev_right, *a,
                  flow_prior=flow_prior, **k)
    ms = [qm(cur_left[i], cur_right[i], prev_left[i], prev_right[i], *a,
             flow_prior=flow_prior[i], **k)
          for i in range(cur_left.shape[0])]
    return vo.QuadMatches(*(torch.stack(x) for x in zip(*ms)))
quadmatch.quad_match = per_candidate_qm
def per_candidate_vo(self, m):
    rs = [vo.estimate_motion(vo.QuadMatches(*(x[i] for x in m)), self.K,
                             self.generator, self.cfg.vo)
          for i in range(m.valid.shape[0])]
    return vo.VoResult(*(torch.stack(x) for x in zip(*rs)))
pipeline.SlamSystem._loop_vo = per_candidate_vo
""",
}

RUN = """
info = c.phase_device()
c.phase_build()
c.phase_epoch(info["card"])
"""

KEYS = ("keyframes", "edges", "loop_edges", "ate_rmse_m", "frames_per_s",
        "seconds", "loop_verify_log", "card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="pairwise,batched,per_candidate")
    args = ap.parse_args()
    for name in args.order.split(","):
        t = time.time()
        res = subprocess.run(
            [sys.executable, "-c", PRELUDE + VARIANTS[name] + RUN],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        epoch = [json.loads(line) for line in res.stdout.splitlines()
                 if line.startswith('{"phase": "epoch"')
                 and '"frames": 250, "tracked"' in line]
        row = {"variant": name, "rc": res.returncode,
               "process_s": round(time.time() - t, 1)}
        if epoch:
            row.update({k: epoch[-1][k] for k in KEYS})
            row["remeasure_ms_a_dispatch"] = \
                epoch[-1]["timer"]["edges/viso"]["mean_ms"]
        else:
            row["stderr"] = res.stderr[-2000:]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
