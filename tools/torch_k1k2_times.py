"""Times of K1 `bf_scan` and K2 `bf_select` of reindexer_tpu_torch, beside
their plain versions and library calls, at the exact select's shapes
(131,072 x 128 at 64 queries and 1 query, 1,048,576 x 128 at 64; L2, k=100).

    python3 tools/torch_k1k2_times.py [--device cuda|cpu] [TREE ...]

Each TREE is a checkout of the repo (a commit unpacked with `git archive`;
default: this one) and is timed in a child process of its own, in the
order given: `OLD NEW NEW OLD` compares two commits on one card. On the
card a time is device time per call (chip_smoke.py's device_ms:
torch.profiler kernel time over 20 calls after warm-up), on the CPU the
median host time of 5 calls (the kernels' plain versions; 131,072 rows
only). The inputs are made from one seed, and S and bmax from the plain
K1, so every tree times the same work. One JSON line per tree and shape:
{"tree", "device", "n_q", "n", "k1", "k1_plain", "k1_lib", "k2",
"k2_plain", "k2_lib"} in ms; the library calls are torch.addmm (TF32 off)
and torch.topk.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, K, SEED = 128, 100, 1234
SHAPES = ((64, 131072), (1, 131072), (64, 1048576))


def host_ms(fn, n: int = 5) -> float:
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def time_tree(tree: str, device: str) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from chip_smoke import device_ms, make_scan_inputs
    sys.path.insert(0, os.path.abspath(tree))
    from reindexer_tpu_torch import VectorMetric
    from reindexer_tpu_torch.ops.scan import (bf_scan, bf_scan_plain,
                                              score_factor)
    from reindexer_tpu_torch.ops.select import bf_select, bf_select_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    timer = device_ms if dev.type == "cuda" else host_ms
    metric = VectorMetric.L2
    fac = score_factor(metric)
    for n_q, n in SHAPES:
        if dev.type == "cpu" and n > 131072:
            continue
        rng = np.random.default_rng(SEED)
        q, base, sq_eff, _ = make_scan_inputs(rng, n, D, n_q, metric, dev)
        s, bmax = bf_scan_plain(q, base, sq_eff, metric)
        eps = torch.zeros(n_q, dtype=torch.float32, device=dev)
        neg_sq = -sq_eff
        t = {"k1": timer(lambda: bf_scan(q, base, sq_eff, metric)),
             "k1_plain": timer(lambda: bf_scan_plain(q, base, sq_eff,
                                                     metric)),
             "k1_lib": timer(lambda: torch.addmm(neg_sq, q, base.T,
                                                 alpha=fac)),
             "k2": timer(lambda: bf_select(s, bmax, eps, K)),
             "k2_plain": timer(lambda: bf_select_plain(s, bmax, eps, K)),
             "k2_lib": timer(lambda: torch.topk(s, K, dim=1))}
        print(json.dumps({"tree": tree, "device": device, "n_q": n_q,
                          "n": n, **t}), flush=True)
        del q, base, sq_eff, s, bmax, neg_sq
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*", default=[ROOT])
    args = ap.parse_args()
    if args.child:
        time_tree(args.trees[0], args.device)
        return 0
    rc = 0
    for tree in args.trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", "--device", args.device,
                              tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
