"""Rank bodies for tests/test_torch_dist.py. They live in their own module,
which imports neither jax nor the reference, because every spawned rank
imports the module that defines its body."""
import time


def raise_on_rank(group, bad_rank):
    """Rank ``bad_rank`` raises at once; the others wait on a collective it
    never joins."""
    if group.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} failed on purpose")
    group.barrier()
    return group.rank


def sleep_forever(group):
    while True:
        time.sleep(1)


def consensus_rows(group, stack):
    """The group's consensus diagnostics from this rank's row of ``stack``."""
    import torch
    from repro_torch.core import consensus
    row = {k: torch.from_numpy(v[group.rank:group.rank + 1]) for k, v in stack.items()}
    div = consensus.divergence_metrics(row, group=group)
    return {"rank": group.rank, "pod": group.pod, "worker": group.worker,
            "world": group.world,
            "aggregate": {k: v.numpy() for k, v in consensus.aggregate(row, group=group).items()},
            "divergence": {k: float(v) for k, v in div.items()},
            "total_sum": float(consensus.total_sum(row, group=group))}


def fleet_and_lockstep(group, job, lockstep):
    """``dist_run``'s rank body, then ``job["peer"]``'s cases through
    ``make_gossip_step(mode="peer")``, then each lockstep case: every step
    starts from the reference's state (this rank's row, memory-mapped from
    .npy files) and its result is held against the reference's next state,
    rtol 1e-4 / atol 1e-5. Returns, per lockstep case, the elements outside
    that tolerance and the largest difference, per step, for theta and the
    velocity."""
    from repro_torch.launch import dist_run
    out = dist_run.run_rank(group, job)
    out["peer"] = {run["tag"]: _peer_rounds(group, run) for run in job["peer"]}
    out["lockstep"] = {case: _lockstep(group, job, run, paths)
                       for case, (run, paths) in lockstep.items()}
    return out


def _peer_rounds(group, run):
    """This rank's ``(peer buffers, gate*coef)`` of every round, as numpy."""
    import torch
    from repro_torch.common.config import ProtocolConfig
    from repro_torch.common.flat import FlatSpec
    from repro_torch.core import gossip_dist
    cfg = ProtocolConfig(codec=run["codec"], **run["protocol"])
    step = gossip_dist.make_gossip_step(group, group.mesh_cfg, cfg, mode="peer")
    stack = {k: torch.as_tensor(v) for k, v in run["params_stack"].items()}
    bufs = {k: b[group.rank:group.rank + 1].contiguous()
            for k, b in FlatSpec.build(stack, leading=1).flatten(stack).items()}
    out = []
    for r in run["rounds"]:
        peer, gc = step(bufs, run["active"], r)
        out.append({**{k: b.numpy() for k, b in peer.items()}, "gc": gc.numpy()})
    return out


def _lockstep(group, job, run, paths):
    import numpy as np
    import torch
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.launch.dist_run import _loss_fn
    from repro_torch.models.simple import params_from_jax
    want = {k: np.load(p, mmap_mode="r") for k, p in paths.items()}
    tr = GossipTrainer(engine="dist", protocol=ProtocolConfig(**run["protocol"]),
                       optimizer=OptimizerConfig(**run["optimizer"]), loss_fn=_loss_fn,
                       codec=run["codec"], device="cpu", group=group, seed=run["seed"])
    state = tr.init_state(0, params=params_from_jax(job["params"], "cpu"))
    r = group.rank
    bufs = {"theta": state.theta["float32"], "velocity": state.opt.mu["float32"]}
    steps = []
    for i in range(run["steps"]):
        for k, buf in bufs.items():
            buf.copy_(torch.from_numpy(np.array(want[k][i, r:r + 1])))
        state, _ = tr.step(state, (torch.from_numpy(job["x"][i, r]),
                                   torch.from_numpy(job["y"][i, r])))
        row = {}
        for k, buf in bufs.items():
            got, ref = buf.numpy(), np.asarray(want[k][i + 1, r:r + 1])
            row[k] = (int((~np.isclose(got, ref, rtol=1e-4, atol=1e-5)).sum()),
                      float(np.abs(got - ref).max()))
        steps.append(row)
    return steps
