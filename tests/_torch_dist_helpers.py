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
    out["peer"] = {run["tag"]: dist_run._peer(group, job, run)["rounds"] for run in job["peer"]}
    out["lockstep"] = {case: _lockstep(group, job, run, paths)
                       for case, (run, paths) in lockstep.items()}
    return out


def _lockstep(group, job, run, paths):
    import numpy as np
    import torch
    from repro_torch.launch.dist_run import _trainer
    from repro_torch.models.simple import params_from_jax
    want = {k: np.load(p, mmap_mode="r") for k, p in paths.items()}
    tr = _trainer(group, run)
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


def publish_rows(group, steps, every):
    """A dist trainer on the MLP (the same seeded init on every rank) with
    ``publish_every=every``: ``steps`` steps, each on this rank's own
    batch. Returns the metrics' ``published_seq`` per step, this rank's
    theta row at each publishing step, what the rank's bus holds and, on
    rank 0, each published snapshot's buffers."""
    import torch
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple
    tr = GossipTrainer(engine="dist", group=group, device="cpu", publish_every=every,
                       protocol=ProtocolConfig(method="elastic_gossip", comm_probability=0.5,
                                               moving_rate=0.5),
                       optimizer=OptimizerConfig(name="nag", learning_rate=0.05, momentum=0.9),
                       loss_fn=lambda p, x, y: simple.xent_loss(simple.mlp_logits(p, x), y),
                       init_fn=lambda g: simple.init_mlp(g, in_dim=10, hidden=16, depth=2,
                                                         num_classes=3)[0])
    state = tr.init_state(0)
    gen = torch.Generator().manual_seed(100 + group.rank)
    seqs, rows, snaps, rejected = [], [], [], False
    for _ in range(steps):
        x, y = torch.randn(8, 10, generator=gen), torch.randint(0, 3, (8,), generator=gen)
        state, m = tr.step(state, (x, y))
        seqs.append(m.get("published_seq"))
        rejected |= "publish_rejected" in m
        if tr._host_steps % every == 0:
            rows.append(state.theta["float32"][0].clone().numpy())
            snap = tr.snapshot_bus.latest()
            snaps.append(None if snap is None else
                         (snap.seq, snap.train_step, snap.bufs["float32"].numpy()))
    return {"rank": group.rank, "seqs": seqs, "rows": rows, "snaps": snaps,
            "bus_seq": tr.snapshot_bus.seq, "rejected": rejected}


def lm_runs(group, job):
    """Runs of the reduced TinyLlama on the dist engine, each from the
    reference's ``init_lm`` parameters (``job["params"]``, numpy) on the
    batches ``job["data"][run["data"]]`` (``tokens`` and ``labels``,
    ``[steps, W, pw, seq]``; rank r trains on row r). A run is ``{"tag",
    "mesh": MeshConfig kwargs, "protocol": ProtocolConfig kwargs, "steps",
    "grad_accum"}``. Returns {tag: the per-step loss, fired, comm_round
    and comm_bytes, the kernel launches and (rank 0) the whole [W, total]
    theta and velocity, float32}."""
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import MeshConfig, OptimizerConfig, ProtocolConfig
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    import torch
    cfg = get_reduced("tinyllama_1_1b")
    params = tr.params_from_jax(job["params"], group.device)
    r, out = group.rank, {}
    for run in job["runs"]:
        trainer = GossipTrainer(
            engine="dist", protocol=ProtocolConfig(**run["protocol"]),
            optimizer=OptimizerConfig(**job["opt"]), model_cfg=cfg, group=group,
            mesh_cfg=MeshConfig(**run["mesh"]), device=group.device,
            grad_accum=run.get("grad_accum", 1))
        state = trainer.init_state(0, params=params)
        data = job["data"][run["data"]]
        ops.zero_launch_counts()
        rec = {k: [] for k in ("loss", "fired", "comm_round", "comm_bytes")}
        for i in range(run["steps"]):
            state, m = trainer.step(state, (torch.from_numpy(data["tokens"][i, r]),
                                            torch.from_numpy(data["labels"][i, r])))
            for k in rec:
                rec[k].append(float(m[k]))
        rec["launches"] = ops.launch_counts()
        full = trainer.dist.gather_state(state)
        if r == 0:
            rec["theta"] = full.theta["float32"].numpy()
            rec["velocity"] = full.opt.mu["float32"].numpy()
        out[run["tag"]] = rec
    return out


def replaced(cfg, fields):
    """``cfg`` with ``fields`` changed; a dict value changes the fields of
    that sub-config (e.g. {"moe": {"num_experts": 6}})."""
    import dataclasses
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
        for k, v in fields.items()})


def tp_cases(group, job):
    """Tensor-parallel serving of each of ``job["cases"]`` (``arch``, the
    reference's ``init_lm`` params as numpy, ``prompt [B, S]`` (audio
    ``[B, K, S]``), the greedy tokens fed to the decode steps ``decode
    [steps, B]`` (audio ``[steps, B, K]``), then to the ``decode_slots``
    steps ``slots`` with ``kv_start [B]``, ``max_len``, ``models``; optional
    ``cond [B, T, e]``, ``replace`` (config fields changed from the reduced
    config, :func:`replaced`) and ``routes`` (record every MoE layer's
    routing ids)), in f32 on the CPU, over this group of 4 ranks and over
    its two halves (ranks 0-1 and 2-3, each a group of 2). Returns {(case,
    M): every step's logits, the collectives of the prefill and of each
    decode step, the count the program expects of each, and the routing
    ids}."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import ModelGroup
    from repro_torch.launch.serve_decode import recorded_routes
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import make_serve_program
    halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    mesh2 = dataclasses.replace(group.mesh_cfg, model=2)
    groups = {4: group, 2: ModelGroup(group.rank % 2, mesh2, group.device,
                                      pg=halves[group.rank // 2])}
    out = {}
    for name, case in job["cases"].items():
        cfg = replaced(get_reduced(case["arch"]), case.get("replace", {}))
        params = tr.params_from_jax(case["params"], "cpu", torch.float32)
        B = case["prompt"].shape[0]
        cond = case.get("cond")
        cond = None if cond is None else torch.from_numpy(cond)
        for M in case["models"]:
            g = groups[M]
            prog = make_serve_program(cfg, batch=B, max_len=case["max_len"],
                                      param_dtype=torch.float32, cache_dtype=torch.float32,
                                      with_prefill=True, device="cpu", mesh_cfg=g.mesh_cfg,
                                      group=g)
            p = prog.place_params(params)
            with recorded_routes(case.get("routes")) as routes:
                g.reset_counts()
                logits, cache = prog.prefill_fn(p, torch.from_numpy(case["prompt"]), cond)
                rec = {"prefill": g.counts(), "steps": [], "logits": [logits.numpy()],
                       "expected": prog.collectives_per_decode_step()}
                kv_start = torch.from_numpy(case["kv_start"])
                for t, tok in enumerate(list(case["decode"]) + list(case.get("slots", []))):
                    g.reset_counts()
                    tok = torch.from_numpy(np.ascontiguousarray(tok))[..., None]
                    if t < len(case["decode"]):
                        logits, cache = prog.decode_fn(p, cache, tok, cond)
                    else:
                        logits, cache = prog.decode_slots_fn(p, cache, tok, cond, kv_start)
                    rec["steps"].append(g.counts())
                    rec["logits"].append(logits.numpy())
            rec["logits"] = np.stack(rec["logits"])
            rec["routes"] = [r.numpy() for r in routes]
            out[(name, M)] = rec
    return out
