#!/usr/bin/env python3
"""Time chip_smoke.py's gluon_train phase (ResNet-50 v1 trained through
the port's Gluon loop) from several checkouts of the repo, in turns, on
one CUDA card, so that two versions of the port compare within one
machine and one power state.

    python3 tools/torch_gluon_train_ab.py OLD NEW NEW OLD OLD NEW NEW OLD

Each argument is the root of a checkout holding chip_smoke.py and
mxnet_tpu_torch/; each run is a fresh process (the two checkouts' packages
share a name), which builds that checkout's kernels on first use. It
prints each run's gluon_train JSON line, then one summary line:
{"gluon_train_ab": [{"root": ..., "img_s": ..., "step_ms": ...}, ...],
"by_root": {root: {"runs": n, "img_s_median": ..., "img_s_min": ...,
"img_s_max": ..., "step_ms_median": ...}}, "card": ...}.
"""
import json
import os
import statistics
import subprocess
import sys

_RUN = r"""
import os, sys
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.gluon_train(torch.device("cuda", 0), c.card_line())
"""


def main(roots):
    if not roots:
        sys.exit(__doc__)
    results = []
    for root in roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", _RUN, root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            sys.exit("gluon_train from %s failed (rc %d)"
                     % (root, out.returncode))
        rec = next(json.loads(line) for line in out.stdout.splitlines()
                   if line.startswith("{") and
                   json.loads(line).get("phase") == "gluon_train")
        print(json.dumps(dict(rec, root=root)), flush=True)
        results.append({"root": root, "img_s": rec["img_s"],
                        "step_ms": rec["step_ms"]})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    by_root = {}
    for root in dict.fromkeys(r["root"] for r in results):
        img_s = [r["img_s"] for r in results if r["root"] == root]
        by_root[root] = {
            "runs": len(img_s), "img_s_median": statistics.median(img_s),
            "img_s_min": min(img_s), "img_s_max": max(img_s),
            "step_ms_median": statistics.median(
                r["step_ms"] for r in results if r["root"] == root)}
    print(json.dumps({"gluon_train_ab": results, "by_root": by_root,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
