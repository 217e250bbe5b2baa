"""Run one cell of the benchmark once, on the CUDA card of this machine:

    python3 -m benchmark_torch.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The last line
of standard output is the result as one JSON object; the numbers compared
with the plain reference, each beside its limit, are the last lines of
standard error and the result's last key, ``checks``. Without a CUDA
device, or with fewer than the cell asks for, it prints why on standard
error and exits 2 with no result: there is no CPU fallback. Where the
process holds JAX or the JAX package once the window has closed, it names
them on standard error and exits 3 with no result: the port runs without
them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


# Top-level module names the measured process may not hold, compared whole
# (``video_stab_tpu_torch`` is the port, ``video_stab_tpu`` the JAX package).
FORBIDDEN = ("jax", "jaxlib", "flax", "video_stab_tpu")


def forbidden_modules() -> list:
    """The FORBIDDEN top-level names that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = Path.cwd()
    with open(root / "BENCHMARK.json") as f:
        manifest = json.load(f)
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    # Build and kernel caches stay in the checkout, at fixed paths.
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA "
              f"device(s); torch sees {have}: no result", file=sys.stderr)
        return 2
    import video_stab_tpu_torch  # noqa: F401  (TF32 off for the program)
    from benchmark_torch import harness
    result = harness.run(manifest, root, args.workload, args.seed,
                         args.seconds, bool(args.trace),
                         torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}, which the port does not use: no "
              f"result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(f"frames compared: {result.pop('frames_compared')} at calls "
          f"{result.pop('sampled_calls')} of {result.pop('calls_made')}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
