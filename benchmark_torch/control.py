"""The readings the limits of ``correct`` are set from, for one cell, on
several seeds in one process:

    python3 -m benchmark_torch.control --workload <cell> \
        --seeds 11,12,13 --seconds 10

For each seed one line of JSON: ``program``, the numbers of a run of the
program (``harness.run``: set-up, the window at the cell's own load, the
comparison of its sampled frames with the reference), and ``control``,
the same numbers for the reference computed in bfloat16 at every stage
(the precision below the configuration's float32) put in the program's
place, on the same calls. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def control_numbers(cfg: dict, seed: int, n_calls: int, calls, device
                    ) -> dict:
    """The comparison's numbers for the bfloat16 reference against the
    float32 one at ``calls`` of a stream of ``n_calls`` calls."""
    from benchmark_torch import compare, harness
    reference = harness.load_reference(cfg)
    pool = harness.make_pool(cfg, seed, device)
    want = reference.outputs(cfg, pool, n_calls, seed, calls)
    got = reference.outputs(cfg, pool, n_calls, seed, calls,
                            precision=torch.bfloat16)
    return compare.numbers({c: v.cpu().numpy() for c, v in got.items()},
                           want)


def readings(manifest: dict, root: Path, workload: str, seeds, seconds,
             device) -> list:
    """Per seed {"seed", "program": numbers, "control": numbers}."""
    from benchmark_torch import harness
    cell = harness.resolve(manifest, workload, root)
    out = []
    for seed in seeds:
        res = harness.run(manifest, root, workload, seed, seconds, False,
                          device)
        calls = res.pop("sampled_calls")
        n_calls = res.pop("calls_made")
        row = {"seed": seed, "correct": res["correct"],
               "program": {k: v["value"] for k, v in res["checks"].items()},
               "control": control_numbers(cell.config, seed, n_calls, calls,
                                          device)}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: no readings", file=sys.stderr)
        return 2
    import video_stab_tpu_torch  # noqa: F401  (TF32 off for the program)
    root = Path.cwd()
    with open(root / "BENCHMARK.json") as f:
        manifest = json.load(f)
    readings(manifest, root, args.workload,
             [int(s) for s in args.seeds.split(",")], args.seconds,
             torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
