"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. Prints, as the
last line of standard output, one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and last ``check``: each number compared beside its limit), and the same
numbers as the last lines of standard error. Exits non-zero, printing no
result, without a CUDA device (or fewer than the cell asks for), on any
error, or if the process holds ``jax``, ``jaxlib``, ``flax`` or ``repro``
once the window has closed. The program builds its CUDA library (B1)
under ``build/`` of the checkout, where later runs find it.

The run sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` before
torch loads. With fixed-size segments the caching allocator reserved 76.4 of
the 79.2 GiB of an H100 80GB HBM3 in the 2 x 4,096 cell, for 54.8 GiB in use;
an allocation that does not fit makes it synchronise and release its cache
before it retries, in the measured window. Expandable segments reserve
56.4 GiB there."""
import os
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    print(f"seconds: import torch {time.perf_counter() - T0:.3f}", file=sys.stderr)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        from bench.harness import forbidden_modules, run_cell
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          spec=spec, t0=T0)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"the run holds modules of the JAX package or JAX itself: {found}",
              file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(result.lines) + "\n")
    sys.stderr.flush()
    print(result.line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
