"""Compare the SASS of the loop kernels of this tree with another tree's, on a CUDA card.

    python3 scripts/torch_sass_diff.py --root DIR [--kernels NAME ...]

Builds this checkout's kernel library and the one of the tree under `--root` (such as the
parent commit unpacked with `git archive`), dumps both with `cuobjdump -sass` (it sits
beside `nvcc`), and for every function whose name holds one of `--kernels` (default: the
NDT and GICP loop kernels) compares the instruction streams with their addresses removed.
Prints one JSON line: per function its instruction count in each tree and the lines that
differ (0: the same code). A header moved or a helper shared between kernels can change
what nvcc schedules without changing a result; this tells the two apart from a timing.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("ndt_iteration_kernel", "ndt_iteration_batched_kernel", "gicp_iteration_kernel")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def functions(sass: str, names) -> dict:
    """{mangled name without its namespace hash: instructions} of the functions named."""
    out = {}
    for f in sass.split("Function : ")[1:]:
        name = f.split("\n", 1)[0].strip()
        if any(n in name for n in names):
            key = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", name)
            out[key] = INSTRUCTION.findall(f)
    return out


def differing(a, b) -> int:
    """The instruction lines that differ between two instruction streams (0: the same
    code)."""
    return sum(1 for line in difflib.unified_diff(a, b, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    from lidar_graph_slam_tpu_torch.ops import kernels

    kernels.load_library()
    other = chip_smoke.tree_kernels(args.root, "other_kernels")
    other.load_library()
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    dumps = [functions(subprocess.run([tool, "-sass", m.build_info["path"]], check=True,
                                      capture_output=True, text=True).stdout, args.kernels)
             for m in (kernels, other)]
    report = {}
    for name in sorted(set(dumps[0]) | set(dumps[1])):
        a, b = dumps[0].get(name, []), dumps[1].get(name, [])
        report[name[:90]] = dict(this=len(a), other=len(b), lines_differing=differing(a, b))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
