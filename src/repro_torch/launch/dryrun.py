"""Dry-run sweep: count every (architecture x input shape) program of one
device on the ``meta`` device and record its memory plan and roofline
(port of ``repro.launch.dryrun``, which lowers and compiles each program
for 512 placeholder TPU devices).

Nothing is allocated and no card is needed: each program of
:func:`repro_torch.launch.specs.build_programs` runs once under
:class:`~repro_torch.analysis.opcount.OpCounter` on ``meta`` tensors.
Records go to ``<out>/<mesh>/<arch>__<shape>__<program>.json`` (``--out``,
default ``build/dryrun``), so an interrupted sweep resumes where it left
off (``--force`` recounts).

Each record has the reference's keys (the roofline's ``to_dict``, ``mesh``,
``status``, ``plan``, ``memory_analysis`` and
``xla_cost_analysis_flops_bodyonce``, null here: no XLA), with the port's
own numbers where the reference reads XLA:

- ``memory_analysis``: ``argument_size_in_bytes`` (the device's
  parameters plus its state or cache and its inputs, summed over the
  ``meta`` tensors), ``output_size_in_bytes`` (the program's outputs) and
  ``temp_size_in_bytes`` (the port's plans: ``launch/train.py``'s
  ``step_memory`` less the two resident planes; the serving prefill's
  temporaries and logits, ``launch/serve_decode.py``'s
  ``prefill_transient_bytes``);
- ``count_seconds`` in place of ``compile_seconds``;
- ``fits`` (argument + temp within the card's HBM), ``refusal`` (the port's
  planner's text where it would refuse, else null), ``chip`` (the spec's
  name), ``compute_dtype`` and ``ops`` (the counted ops by name, the
  kernels under their own).

A program that raises is a ``status: "error"`` record with its traceback,
and the run exits 1; a program that does not fit one card is ``status:
"ok"`` with ``fits: false``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force] [--table]

``--table`` ends the run with a markdown table of its records, one row a
program.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.analysis import roofline as rf
from repro_torch.analysis.opcount import OpCounter, tensor_bytes
from repro_torch.common.config import INPUT_SHAPES
from repro_torch.common.hardware import H100_SXM
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import plans as plans_mod
from repro_torch.launch.specs import PARAM_DTYPE, build_programs

OUT_ROOT = os.path.join("build", "dryrun")


def _out_bytes(out) -> int:
    """Bytes of a program's outputs (a FlatState's buffers, or the logits
    and the cache)."""
    if hasattr(out, "theta"):
        out = (out.theta, out.opt.mu, out.center, out.comm.residual)
    return sum(tensor_bytes(t) for t in tree_leaves(out))


def count_program(prog, arch: str, shape, cfg, chips: int) -> dict:
    """Count one program and return its record's numbers (no status), over
    the H100 SXM's spec."""
    spec = H100_SXM
    t0 = time.time()
    with OpCounter() as c:
        out = prog.fn(*prog.args)
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict) \
            and hasattr(out[0], "theta"):
        out = out[0]                       # (state, metrics)
    mem = {"argument_size_in_bytes": int(prog.argument_bytes),
           "output_size_in_bytes": int(_out_bytes(out)),
           "temp_size_in_bytes": int(prog.temp_bytes)}
    roof = rf.analyze_program(arch, shape, prog.name, c.costs, cfg, chips,
                              peak_memory=prog.temp_bytes, spec=spec, dtype=PARAM_DTYPE)
    rec = roof.to_dict()
    rec.update({
        "count_seconds": time.time() - t0,
        "memory_analysis": mem,
        "fits": mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] <= spec.hbm_capacity,
        "refusal": prog.refusal,
        "chip": spec.name,
        "compute_dtype": str(PARAM_DTYPE).split(".")[-1],
        "ops": dict(sorted(c.costs.ops.items())),
        "xla_cost_analysis_flops_bodyonce": None,
    })
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, force: bool = False,
             gossip_variant: bool = True, out_root: str = OUT_ROOT) -> list:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    outdir = os.path.join(out_root, mesh_name)
    os.makedirs(outdir, exist_ok=True)
    plan = plans_mod.make_plan(arch, shape_name)
    cfg = get_config(arch)
    chips = plans_mod.mesh_config(plan, multi_pod=multi_pod).num_chips
    names = ["train", "train_gossip"] if plan.shape.kind == "train" else [plan.shape.kind]
    if not gossip_variant:
        names = names[:1]
    paths = {n: os.path.join(outdir, f"{arch}__{shape_name}__{n}.json") for n in names}
    if not force and all(os.path.exists(p) for p in paths.values()):
        results = []
        for n, p in paths.items():
            with open(p) as f:
                results.append(json.load(f))
            print(f"[skip] {mesh_name} {arch} {shape_name} {n} (cached)", flush=True)
        return results
    base = {"mesh": mesh_name, "arch": arch, "shape": shape_name,
            "plan": {"workers_per_pod": plan.workers_per_pod, "grad_accum": plan.grad_accum,
                     "decode_window": plan.decode_window, "notes": plan.notes}}
    t0 = time.time()
    try:
        progs = build_programs(arch, shape_name, multi_pod=multi_pod,
                               gossip_variant=gossip_variant)
    except Exception as e:  # noqa: BLE001 - a failing cell is a fault to record
        progs = [(n, e, traceback.format_exc()) for n in names]
    results = []
    for prog in progs:
        if isinstance(prog, tuple):
            name, err, tb = prog
            rec = dict(base, program=name, status="error", error=f"{type(err).__name__}: {err}",
                       traceback=tb, count_seconds=time.time() - t0)
        else:
            name = prog.name
            t1 = time.time()
            try:
                rec = dict(base, **count_program(prog, arch, plan.shape, cfg, chips),
                           status="ok")
                rec["plan"] = base["plan"]
                print(f"[ok]   {mesh_name} {arch} {shape_name} {name} "
                      f"({rec['count_seconds']:.1f}s, bottleneck={rec['bottleneck']}, "
                      f"fits={rec['fits']})", flush=True)
            except Exception as e:  # noqa: BLE001
                rec = dict(base, program=name, status="error",
                           error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc(),
                           count_seconds=time.time() - t1)
        if rec["status"] == "error":
            print(f"[FAIL] {mesh_name} {arch} {shape_name} {name}: {rec['error']}", flush=True)
        with open(paths[name], "w") as f:
            json.dump(rec, f, indent=2)
        results.append(rec)
    return results


def table(records: list) -> str:
    """A markdown table of dry-run records: per-device memory plan, fits,
    model and counted FLOPs, counted bytes, the three terms, the
    bottleneck and the count's seconds."""
    gib = 2.0 ** 30
    lines = ["| arch | shape | program | argument GiB | temp GiB | fits | model FLOPs | "
             "counted FLOPs | bytes | compute ms | memory ms | collective ms | bottleneck | "
             "count s |", "|" + "---|" * 14]
    for r in records:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['program']} | error: "
                         f"{r['error']} |" + " |" * 10)
            continue
        m = r["memory_analysis"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['program']} | "
            f"{m['argument_size_in_bytes'] / gib:.2f} | {m['temp_size_in_bytes'] / gib:.2f} | "
            f"{'yes' if r['fits'] else 'no'} | {r['model_flops']:.3e} | "
            f"{r['flops_per_chip']:.3e} | {r['bytes_per_chip']:.3e} | "
            f"{r['t_compute_s'] * 1e3:.4g} | {r['t_memory_s'] * 1e3:.4g} | "
            f"{r['t_collective_s'] * 1e3:.4g} | {r['bottleneck']} | {r['count_seconds']:.1f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-gossip-variant", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="end with a markdown table of the records")
    ap.add_argument("--out", default=OUT_ROOT,
                    help=f"records go to OUT/<mesh>/ (default {OUT_ROOT})")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    torch.set_grad_enabled(True)
    failures = 0
    t0 = time.time()
    records = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                recs = run_cell(arch, shape, multi_pod=multi_pod, force=args.force,
                                gossip_variant=not args.no_gossip_variant, out_root=args.out)
                failures += sum(r.get("status") != "ok" for r in recs)
                records += recs
    print(f"done in {time.time() - t0:.1f} s; failures={failures}", flush=True)
    if args.table:
        print(table(records))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
