#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json on the card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the checkout's root. The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
the comparison with the reference checked, each beside its limit. With
--trace 0 the metrics are the cell's end-to-end ones, with --trace 1 its
per-layer ones, read over the window and a profiled phase that follows it.

One option serves the setting of limits and is not part of a check:
--control tf32 puts the TF32 reference (h100bench/control.py) in the
engine's place. Without a CUDA card the run fails: there is no CPU
fallback.
"""
import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _process_age_s()

import argparse      # noqa: E402
import json          # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names no run may load: JAX, the JAX package, and the
# repository's JAX-era measurement scripts
FORBIDDEN = {"jax", "jaxlib", "flax", "reindexer_tpu", "bench", "chip_smoke",
             "tools"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",))
    args = ap.parse_args()

    # every build and kernel cache at a fixed path inside the checkout
    cache = os.path.join(ROOT, "build", "h100bench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch
    from h100bench.harness import runner, spec

    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[device] the cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 2
    torch.cuda.reset_peak_memory_stats()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    result = runner.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), T_START,
                        control=args.control == "tf32")
    found = forbidden_loaded()
    if found:
        log(f"[guard] loaded in this process: {', '.join(found)}: "
            "no result")
        return 3
    print(json.dumps(result), flush=True)
    for name, n in result["checks"].items():
        log(f"[check] {name} {n['value']!r} limit {n['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
