"""The readings that set a cell's limits, on the chip: the control and the
planted faults, each read by ``bench/check.py`` against the f32 reference.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--out FILE]

For each seed the plain reference follows the cell's checked steps in f32
(the stand-in for a sound program), then again in place of the program:

- ``tf32``: in TF32, the precision below the configuration's f32 (the
  control, which has to fail a limit);
- ``half_batch``: its loss over half of each batch, the mean taken over the
  rest;
- ``no_exchange``: the elastic exchange between the workers left out.

Each reading is also judged against the cell's limits (``limits/<cell>.json``)
by the harness's own verdict, which has to come out false. A step that
leaves its state unchanged reads 1 on ``grad1_gap`` by the check's measure
and needs no run. The benchmark's own runs never run this. Prints one JSON
line a seed and reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("tf32", "half_batch", "no_exchange")


def as_program(ref: dict) -> dict:
    """A reference run's readings in the form the check takes a program's."""
    return {"loss_mean": [sum(x) / len(x) for x in ref["losses"]],
            "loss_max": [max(x) for x in ref["losses"]],
            "grad1": ref["grad1"], "change": ref["change"]}


def readings(name: str, seed: int, device="cuda", faults=FAULTS, spec=None,
             bench_dir=None) -> dict:
    """{fault: {number: value, "correct": the verdict under the cell's
    limits}} of one seed."""
    import torch

    from bench import check, harness, weights
    from bench.reference import train as ref_train
    spec = harness.load_spec() if spec is None else spec
    cell = harness.find_cell(spec, name, bench_dir or harness.BENCH)
    c, tr, model = cell.config, cell.traffic, cell.reference
    feed = harness.Feed(tr, c["vocab_size"], seed, torch.device(device))
    n = tr["checked_steps"]
    args = ([feed.batch(i) for i in range(n)], [feed.draws(i) for i in range(n)])
    kw = dict(lr=tr["lr"], momentum=tr["momentum"], alpha=tr["alpha"])
    table = model.param_table(c)
    base = ref_train.run(model, c, weights.make(table, seed, device), *args, **kw)
    out = {}
    for f in faults:
        t = time.perf_counter()
        got = ref_train.run(model, c, weights.make(table, seed, device), *args,
                            tf32=(f == "tf32"), fault=None if f == "tf32" else f, **kw)
        nums = check.compare(as_program(got), base)
        out[f] = {k: v["value"] for k, v in nums.items()}
        out[f]["correct"] = check.verdict(nums, cell.limits)
        out[f]["worst"] = {k: v["worst"] for k, v in nums.items()}
        out[f]["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=list(FAULTS), choices=FAULTS)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    lines = []
    for seed in args.seeds:
        for fault, nums in readings(args.workload, seed, faults=args.faults).items():
            lines.append(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                                     **nums}))
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
