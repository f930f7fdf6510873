"""Device ms of one tree's captured fused step and keyframe insert on a CUDA card.

    python3 scripts/torch_captured_replays.py --root DIR [--method GICP] [--frames 10]

Runs `chip_smoke.captured_front` of the tree under DIR (this checkout, or a parent commit
unpacked with `git archive`, with its own package and `chip_smoke.py`) on the first
`--frames` frames of the dense course with that matcher, loops off: the front end's step
and insert-and-rebuild as captured programs, each replay timed between CUDA events, the
rows held bit for bit against the plain bodies. Prints one JSON line: the tree, the
card's name and power limit, the p50 device ms of a step replay and of an insert
replay, their host us, and the rows (poses, flags, fitness, iterations, inliers) of the
frames as a hex digest, so that two trees' runs can be compared. `chip_smoke.py --parent
DIR` runs it for both trees in turns (this, parent, parent, this).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--method", default="GICP", choices=("NDT", "GICP", "ICP"))
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("torch_captured_replays: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    scans, _gt = chip_smoke.dense_course(args.frames)
    cfg = chip_smoke.loops_off_config([f"scan_matcher.registration_method={args.method}"])
    rec = chip_smoke.captured_front(cfg, scans, dev)
    rows = chip_smoke.plain_front_rows(cfg, scans, dev)[:, chip_smoke.CAPTURED_COLUMNS]
    print(json.dumps(dict(
        root=root, card=card, method=args.method, frames=args.frames,
        step_device_ms_p50=rec["step_device_ms_p50"],
        insert_device_ms_p50=rec["insert_device_ms_p50"],
        step_host_us_p50=rec["step_host_us_p50"], insert_host_us_p50=rec["insert_host_us_p50"],
        rows_digest=hashlib.sha1(np.ascontiguousarray(rows).tobytes()).hexdigest())),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
