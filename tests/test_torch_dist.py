"""The port's dist engine against the reference's.

The reference's dist engine runs in one subprocess with 8 fake devices
(module-scoped: every case it computes goes into one .npz). The port runs
as real gloo process groups on the CPU, one process per worker, spawned
once per mesh shape (8 ranks as 2 pods x 4 workers, 4 ranks as 1 pod x 4
workers). Checked: the static schedules and the host scheduler bit for
bit, one gossip round against the reference's dist engine and the port's
sim oracle, 20-step trajectories of every protocol (clipped and trimmed
gossip included) within rtol 1e-4 / atol 1e-5 with the counters
bit-equal, the count of sends and receives, and a failing or hanging rank
failing the group. The sharded plane (slice 4b) on the 4-worker fleet
(fsdp = S = 2, the reference's mesh): a q8 trajectory, stepped from the
reference's state too, and q8 / top-k exchange rounds; ShardConfig() and a
recording ObsConfig bit-exact against the plain run, rank 0's trace and
metrics checked (slice 6)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.api import registry as jregistry  # noqa: E402
from repro.common.config import MeshConfig as JMesh  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.core import gossip_dist as jgd  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.scheduler import GossipSchedule as JSchedule  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.api import registry as tregistry  # noqa: E402
from repro_torch.common.config import MeshConfig as TMesh  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.common.config import ShardConfig as TShard  # noqa: E402
from repro_torch.core import gossip_dist as tgd  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.scheduler import GossipSchedule as TSchedule  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

import _torch_dist_helpers as helpers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, HID, DEPTH, NCLS, PW, STEPS = 784, 64, 2, 10, 4, 20
OPT = dict(name="nag", learning_rate=0.01, momentum=0.9)
# (pods, workers_per_pod) of the two fleets; the reference's mesh for the
# 4-worker fleet has fsdp = 2 (8 fake devices), which replicates the plane
FLEETS = {"w8": (2, 4), "w4": (1, 4)}
# the paper's Table 4.1 gate: about a third of the steps at W = 8 fire for
# nobody, so the non-firing path (kernel B2 on the card) runs too
EG = dict(method="elastic_gossip", comm_probability=0.125, moving_rate=0.5)
# case -> (fleet, protocol kwargs, codec, fused_update)
TRAJ = {
    "elastic_fused": ("w8", EG, "none", True),
    "elastic_unfused": ("w8", EG, "none", False),
    "pull": ("w8", dict(method="gossiping_pull", comm_period=2), "none", True),
    "push": ("w8", dict(method="gossiping_push", comm_probability=0.3), "none", True),
    "allreduce": ("w8", dict(method="allreduce"), "none", True),
    "easgd": ("w8", dict(method="easgd", comm_probability=0.5, moving_rate=0.1), "none", True),
    "elastic_q8": ("w8", EG, "q8", True),
    "elastic_uniform_w4": ("w4", dict(EG, topology="uniform"), "none", True),
    # the robust protocols inherit ElasticGossip.pair_gate_coef: on the dist
    # engine they mix as plain elastic gossip, in both packages
    "clipped": ("w8", dict(EG, method="clipped_gossip", robust_clip=0.1), "none", True),
    "trimmed": ("w8", dict(EG, method="trimmed_gossip", robust_trim=1.5), "none", True),
    "elastic_shard2_w4": ("w4", dict(EG, topology="uniform"), "none", True),
    "elastic_q8_shard2_w4": ("w4", dict(EG, topology="uniform"), "q8", True),
}
# case -> n_shards (the reference's 4-worker mesh has fsdp = 2)
SHARD = {"elastic_shard2_w4": 2, "elastic_q8_shard2_w4": 2, "elastic_gossip_q8_shard2_w4": 2,
         "elastic_gossip_topk_shard2_w4": 2}
# cases whose free run leaves the tolerance from one q8 flip: its values are
# held by the lockstep test (every step from the reference's state), the
# free run by its counters. At batch 4 the one flip both packages' runs of
# this config see at step 4 (as the un-sharded w4 run does) reaches a ReLU
# boundary at step 13 and moves ~20,000 elements on a step where nothing
# fires, as the CNN's free runs do (ROADMAP C, "Deliberate differences").
FREE_RUN_COUNTERS_ONLY = ("elastic_q8_shard2_w4",)
# exchange case -> (fleet, protocol kwargs, codec)
EXCH = {f"{m}_{f}": (f, dict(method=m, comm_probability=0.5, moving_rate=0.37), "none")
        for m in ("elastic_gossip", "gossiping_pull", "gossiping_push") for f in FLEETS}
EXCH["elastic_gossip_q8_w8"] = ("w8", dict(EXCH["elastic_gossip_w8"][1]), "q8")
for _c in ("q8", "topk"):
    EXCH[f"elastic_gossip_{_c}_shard2_w4"] = ("w4", dict(EXCH["elastic_gossip_w4"][1]), _c)
SEED = 3
# the reference's dist facade writes a checkpoint at the end of this case;
# the port's w8 group saves and resumes the same protocol (dist_run's
# "resume" run) and the two files' entries are compared
CKPT_CASE = "elastic_fused"
# cases also run in lockstep: every step starts from the reference's state
LOCKSTEP = ("elastic_q8", "elastic_q8_shard2_w4")
# port-only runs of the uniform w4 case, held bit-exact against its plain
# run: the inert ShardConfig() and a recording ObsConfig (rank 0 records)
ANCHORS = {"anchor_shard1": dict(shard=1), "anchor_obs_default": dict(obs={}),
           "anchor_obs": dict(obs=dict(trace=True, metrics=True))}


def _mesh(cls, fleet, data=None):
    pods, wpp = FLEETS[fleet]
    return cls(data=data or wpp, model=1, pods=pods, workers_per_pod=wpp)


REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.api import GossipTrainer
from repro.common.config import MeshConfig, OptimizerConfig, ProtocolConfig, ShardConfig
from repro.common.flat import FlatSpec
from repro.configs import get_reduced
from repro.data import partition as jpart, synthetic as jsyn
from repro.launch.mesh import make_worker_mesh
from repro.models import simple as jsimple

spec = json.loads(sys.argv[2])
IN, HID, DEPTH, NCLS, PW, STEPS = spec["dims"]
out = {}
params = jsimple.init_mlp(jax.random.PRNGKey(0), IN, HID, DEPTH, NCLS)[0]
for k, v in params.items():
    out["params/" + k] = np.asarray(v)
axes = jax.tree.map(lambda x: (None,) * x.ndim, params)
model_cfg = get_reduced("tinyllama_1_1b")   # batch axes only
train, _ = jsyn.load_mnist(data_dir="", num_train=1024, num_test=64)

def loss_fn(p, b):
    return jsimple.xent_loss(jsimple.mlp_logits(p, b["tokens"]), b["labels"][:, 0])

meshes = {}
for fleet, (pods, wpp) in spec["fleets"].items():
    mcfg = MeshConfig(data=8 // pods, model=1, pods=pods, workers_per_pod=wpp)
    meshes[fleet] = (mcfg, make_worker_mesh(mcfg))
    W = mcfg.num_workers
    shards = jpart.partition_iid(train, W, 0)
    xs, ys = zip(*(jpart.batches_for_step(shards, i, PW) for i in range(STEPS)))
    out[fleet + "/x"], out[fleet + "/y"] = np.stack(xs), np.stack(ys).astype(np.int32)

def trainer(fleet, proto, case=None, **kw):
    mcfg, mesh = meshes[fleet]
    if case in spec["shard"]:
        kw["shard"] = ShardConfig(n_shards=spec["shard"][case])
    return GossipTrainer(engine="dist", protocol=proto, mesh=mesh, mesh_cfg=mcfg,
                         model_cfg=model_cfg, init_fn=lambda key: params, params_axes=axes,
                         global_batch=mcfg.num_workers * PW, seq_len=IN, loss_fn=loss_fn,
                         seed=spec["seed"], **kw)

for case, (fleet, pkw, codec, fused) in spec["traj"].items():
    tr = trainer(fleet, ProtocolConfig(codec=codec, **pkw), case,
                 optimizer=OptimizerConfig(**spec["opt"]), fused_update=fused)
    st = tr.init_state(0)
    rec = {k: [] for k in ("loss", "fired", "comm_round", "comm_bytes")}
    if case in spec["lockstep"]:
        rec["steps_theta"] = [np.asarray(st.theta["float32"])]
        rec["steps_velocity"] = [np.asarray(st.opt.mu["float32"])]
    for i in range(STEPS):
        b = {"tokens": jnp.asarray(out[fleet + "/x"][i]),
             "labels": jnp.asarray(out[fleet + "/y"][i])[..., None]}
        st, m = tr.step(st, b)
        for k in ("loss", "fired", "comm_round", "comm_bytes"):
            rec[k].append(np.asarray(m[k]))
        if case in spec["lockstep"]:
            rec["steps_theta"].append(np.asarray(st.theta["float32"]))
            rec["steps_velocity"].append(np.asarray(st.opt.mu["float32"]))
    for k, v in rec.items():
        out[f"traj/{case}/{k}"] = np.asarray(v)
    out[f"traj/{case}/theta"] = np.asarray(st.theta["float32"])
    out[f"traj/{case}/wire"] = np.asarray(tr._backend.wire_bytes())
    out[f"traj/{case}/velocity"] = np.asarray(st.opt.mu["float32"])
    if case == spec["ckpt_case"]:
        tr.save_checkpoint(spec["ckpt"], st, meta={"step": STEPS})

rng = np.random.RandomState(1)
for fleet, (pods, wpp) in spec["fleets"].items():
    mcfg, mesh = meshes[fleet]
    W = mcfg.num_workers
    stack = {"w": rng.randn(W, 16, 8).astype(np.float32), "b": rng.randn(W, 8).astype(np.float32)}
    active = (rng.rand(W) < 0.6).astype(np.float32)
    out[fleet + "/stack/w"], out[fleet + "/stack/b"] = stack["w"], stack["b"]
    out[fleet + "/active"] = active
for case, (fleet, pkw, codec) in spec["exch"].items():
    mcfg, mesh = meshes[fleet]
    stack = {k: jax.device_put(jnp.asarray(out[f"{fleet}/stack/{k}"]),
                               NamedSharding(mesh, P(("pod", "worker"))))
             for k in ("w", "b")}
    tr = trainer(fleet, ProtocolConfig(codec=codec, **pkw), case)
    out[f"exch/{case}/rounds"] = np.asarray(tr.num_gossip_rounds)

    # mode="peer" over the flat plane: the peer's buffers and gate*coef
    peer_step = tr._backend.trainer._make_gossip("peer")
    bufs = FlatSpec.build(stack, leading=1).flatten(stack)
    for r in range(tr.num_gossip_rounds):
        got = tr.gossip_exchange(stack, jnp.asarray(out[fleet + "/active"]), r)
        out[f"exch/{case}/partners/{r}"] = np.asarray(tr.matching_partners(r))
        for k in ("w", "b"):
            out[f"exch/{case}/{r}/{k}"] = np.asarray(got[k])
        if case in spec["shard"]:
            continue
        peer, gc = peer_step(bufs, jnp.asarray(out[fleet + "/active"]), jnp.int32(r))
        out[f"peer/{case}/{r}/float32"] = np.asarray(peer["float32"])
        out[f"peer/{case}/{r}/gc"] = np.asarray(gc)
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case, computed once in a subprocess with 8 fake
    devices."""
    tmp = tmp_path_factory.mktemp("ref_dist")
    path = str(tmp / "ref.npz")
    spec = dict(dims=[IN, HID, DEPTH, NCLS, PW, STEPS], fleets=FLEETS, seed=SEED, opt=OPT,
                traj=TRAJ, exch=EXCH, lockstep=LOCKSTEP, ckpt_case=CKPT_CASE,
                ckpt=str(tmp / "ckpt.npz"), shard=SHARD)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT), path,
                        json.dumps(spec)], capture_output=True, text=True, timeout=400,
                       env=env)
    assert r.returncode == 0 and "REF_OK" in r.stdout, f"{r.stdout}\n{r.stderr}"
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["ckpt_path"] = spec["ckpt"]
    return out


def _fleet_job(ref, fleet):
    params = {k[len("params/"):]: v for k, v in ref.items() if k.startswith("params/")}
    runs = []
    for case, (f, pkw, codec, fused) in TRAJ.items():
        if f == fleet:
            runs.append(dict(kind="train", tag=case, protocol=pkw, codec=codec,
                             fused_update=fused, optimizer=OPT, steps=STEPS, seed=SEED,
                             gather=True, **_shard(case)))
    if fleet == TRAJ[ANCHOR_OF][0]:
        _, pkw, codec, fused = TRAJ[ANCHOR_OF]
        for tag, extra in ANCHORS.items():
            runs.append(dict(kind="train", tag=tag, protocol=pkw, codec=codec,
                             fused_update=fused, optimizer=OPT, steps=STEPS, seed=SEED,
                             gather=True, **extra))
    stack = {k: ref[f"{fleet}/stack/{k}"] for k in ("w", "b")}
    for case, (f, pkw, codec) in EXCH.items():
        if f == fleet:
            runs.append(dict(kind="exchange", tag=case, protocol=pkw, codec=codec,
                             params_stack=stack, active=ref[f"{fleet}/active"],
                             rounds=list(range(int(ref[f"exch/{case}/rounds"]))),
                             **_shard(case)))
    peer = [dict(tag=case, protocol=pkw, codec=codec, params_stack=stack,
                 active=ref[f"{fleet}/active"],
                 rounds=list(range(int(ref[f"exch/{case}/rounds"]))))
            for case, (f, pkw, codec) in EXCH.items() if f == fleet and case not in SHARD]
    # one send and one recv per BUCKET: a stack with an f32 and a bf16 bucket
    runs.append(dict(kind="exchange", tag="two_buckets", protocol=EG, codec="none",
                     params_stack=_two_buckets(ref, fleet), active=ref[f"{fleet}/active"],
                     rounds=[0, 1]))
    return dict(params=params, x=ref[f"{fleet}/x"], y=ref[f"{fleet}/y"], runs=runs,
                peer=peer)


# the case the ANCHORS runs repeat
ANCHOR_OF = "elastic_uniform_w4"


def _shard(case):
    return {"shard": SHARD[case]} if case in SHARD else {}


def _two_buckets(ref, fleet):
    return {"w": torch.from_numpy(ref[f"{fleet}/stack/w"]),
            "b": torch.from_numpy(ref[f"{fleet}/stack/b"]).to(torch.bfloat16)}


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """The port's runs on both fleets, {fleet: [rank results]}, one spawned
    group per fleet; the lockstep cases ride on their fleet's group."""
    out = {}
    for fleet in FLEETS:
        tmp = tmp_path_factory.mktemp(fleet)
        job = _fleet_job(ref, fleet)
        lock = {}
        for case in LOCKSTEP:
            if TRAJ[case][0] == fleet:
                paths = {}
                for k in ("theta", "velocity"):
                    paths[k] = str(tmp / f"{case}_{k}.npy")
                    np.save(paths[k], ref[f"traj/{case}/steps_{k}"])
                run = next(r for r in job["runs"] if r["tag"] == case)
                lock[case] = (run, paths)
        if fleet == TRAJ[CKPT_CASE][0]:
            job["runs"].append(dict(kind="resume", tag="resume", protocol=TRAJ[CKPT_CASE][1],
                                    codec="none", optimizer=OPT, steps=6, seed=SEED, at=3,
                                    path=str(tmp / "port_ckpt.npz")))
        out[fleet] = tmesh.spawn_workers(helpers.fleet_and_lockstep, _mesh(TMesh, fleet),
                                         "cpu", args=(job, lock), timeout_s=60,
                                         join_timeout_s=300, rendezvous_dir=str(tmp))
    return out


def _run(port, fleet, tag, rank=0):
    return next(r for r in port[fleet][rank]["runs"] if r["tag"] == tag)


# ---------------------------------------------------------------------------
# the schedules and the host scheduler: numpy, bit for bit
# ---------------------------------------------------------------------------

SCHED_MESHES = [(W, pods) for W in (4, 8) for pods in (1, 2)]


def _meshes(W, pods):
    wpp = W // pods
    return (JMesh(data=wpp, model=1, pods=pods, workers_per_pod=wpp),
            TMesh(data=wpp, model=1, pods=pods, workers_per_pod=wpp))


@pytest.mark.parametrize("W,pods", SCHED_MESHES)
@pytest.mark.parametrize("topology", ["matching", "uniform"])
def test_schedule_and_partners_match_reference(W, pods, topology):
    jm, tm = _meshes(W, pods)
    kind = "hypercube" if topology == "matching" else "random"
    js, ts = jgd.build_schedule(jm, kind), tgd.build_schedule(tm, kind)
    assert ts == js and len(ts) > 0
    for _, pairs in ts:
        a, b = ttopo.matching_partner_array(pairs), jtopo.matching_partner_array(pairs)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for r in range(2 * len(js) + 1):
        for w in range(W):
            assert tgd.partner_of(ts, r, w, tm) == jgd.partner_of(js, r, w, jm)
    jp = jregistry.resolve(JProto(comm_probability=0.5, topology=topology))
    tp = tregistry.resolve(TProto(comm_probability=0.5, topology=topology))
    assert tp.schedule_rounds(W, mesh_cfg=tm) == jp.schedule_rounds(W, mesh_cfg=jm)
    for r in range(2 * len(js) + 1):
        a, b = tp.schedule_partners(r, W, mesh_cfg=tm), jp.schedule_partners(r, W, mesh_cfg=jm)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert sorted(a[a]) == list(range(W))      # a perfect matching


SCHED_PROTOS = {"elastic_p": dict(method="elastic_gossip", comm_probability=0.3),
                "easgd_p": dict(method="easgd", comm_probability=0.3),
                "pull_tau": dict(method="gossiping_pull", comm_period=3),
                "allreduce": dict(method="allreduce")}


@pytest.mark.parametrize("W,pods", SCHED_MESHES)
@pytest.mark.parametrize("topology", ["matching", "uniform"])
@pytest.mark.parametrize("proto", sorted(SCHED_PROTOS))
def test_gossip_schedule_polls_and_restores_as_reference(W, pods, topology, proto):
    """(fire, active, round) and partners() bit for bit over 40 steps; the
    state snapshot round-trips between the two packages mid-run."""
    jm, tm = _meshes(W, pods)
    kw = dict(SCHED_PROTOS[proto], topology=topology)
    js = JSchedule(JProto(**kw), W, seed=5, mesh_cfg=jm)
    ts = TSchedule(TProto(**kw), W, seed=5, mesh_cfg=tm)
    assert ts.num_rounds() == js.num_rounds() if jregistry.resolve(JProto(**kw)).pairwise \
        else True

    def same(a, b):
        assert a[0] == b[0] and a[2] == b[2]
        assert (a[1] is None) == (b[1] is None)
        if a[1] is not None:
            assert a[1].dtype == b[1].dtype and np.array_equal(a[1], b[1])

    for step in range(20):
        same(ts.poll(step), js.poll(step))
        pa, pb = ts.partners(), js.partners()
        assert (pa is None and pb is None) or np.array_equal(pa, pb)
    snap = js.state()
    assert ts.state() == snap
    back = TSchedule(TProto(**kw), W, seed=99, mesh_cfg=tm)
    back.restore(snap)
    forth = JSchedule(JProto(**kw), W, seed=98, mesh_cfg=jm)
    forth.restore(ts.state())
    for step in range(20, 40):
        a, b, c = back.poll(step), js.poll(step), forth.poll(step)
        same(a, b)
        same(c, b)
    with pytest.raises(ValueError, match="workers"):
        TSchedule(TProto(**kw), 2 * W, mesh_cfg=tm).restore(snap)


# ---------------------------------------------------------------------------
# one gossip round: reference dist engine, port dist engine, port sim oracle
# ---------------------------------------------------------------------------

def _dummy_loss(p, x, y):
    return torch.zeros(())


@pytest.mark.parametrize("case", sorted(EXCH))
def test_gossip_exchange_matches_reference_and_sim_oracle(ref, port, case):
    """Every round of the schedule: rtol = atol = 1e-6 (the dist engine
    moves b - coef*(b - peer), the oracle multiplies by the mixing matrix;
    the two round differently)."""
    fleet, pkw, codec = EXCH[case]
    got = _run(port, fleet, case)
    rounds = int(ref[f"exch/{case}/rounds"])
    assert got["num_gossip_rounds"] == rounds == len(got["rounds"])
    tm = _mesh(TMesh, fleet)
    shard = TShard(n_shards=SHARD[case]) if case in SHARD else None
    sim = TTrainer(engine="sim", protocol=TProto(codec=codec, **pkw), loss_fn=_dummy_loss,
                   num_workers=tm.num_workers, mesh_cfg=tm, device="cpu", shard=shard)
    assert sim.num_gossip_rounds == rounds

    stack = {k: torch.from_numpy(ref[f"{fleet}/stack/{k}"]) for k in ("w", "b")}
    tol = dict(rtol=1e-6, atol=1e-6)
    for r in range(rounds):
        partners = ref[f"exch/{case}/partners/{r}"]
        assert np.array_equal(got["partners"][r], partners)
        assert np.array_equal(sim.matching_partners(r), partners)
        oracle = sim.gossip_exchange(stack, ref[f"{fleet}/active"], r)
        for k in ("w", "b"):
            want = ref[f"exch/{case}/{r}/{k}"]
            np.testing.assert_allclose(got["rounds"][r][k], want, **tol, err_msg=f"{r} {k}")
            np.testing.assert_allclose(oracle[k].numpy(), want, **tol, err_msg=f"{r} {k}")
    # one send and one recv per round on every rank (one bucket)
    for rank in port[fleet]:
        run = next(x for x in rank["runs"] if x["tag"] == case)
        assert run["sends"] == run["recvs"] == rounds


@pytest.mark.parametrize("case", sorted(c for c in EXCH if c not in SHARD))
def test_peer_mode_matches_reference(ref, port, case):
    """make_gossip_step(mode="peer") on every rank and round: the peer's
    buffers (the wire decoded, bit for bit: the same bytes crossed it) and
    gate*coef equal the reference's mode="peer" row for that worker."""
    fleet = EXCH[case][0]
    rounds = int(ref[f"exch/{case}/rounds"])
    for rank in port[fleet]:
        got = rank["peer"][case]
        assert len(got) == rounds
        for r in range(rounds):
            r_ = rank["rank"]
            np.testing.assert_array_equal(
                got[r]["float32"], ref[f"peer/{case}/{r}/float32"][r_:r_ + 1],
                err_msg=f"rank {r_} round {r}")
            np.testing.assert_array_equal(got[r]["gc"], ref[f"peer/{case}/{r}/gc"][r_:r_ + 1],
                                          err_msg=f"rank {r_} round {r}")


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_one_send_and_recv_per_bucket_per_round(ref, port, fleet):
    """A stack with an f32 and a bf16 bucket: two sends and two receives
    per round on every rank (the gate rides in the first bucket's tail);
    the result equals the sim oracle (f32 1e-6, bf16 2e-2: the dist engine
    computes in the storage dtype)."""
    W = _mesh(TMesh, fleet).num_workers
    for rank in port[fleet]:
        run = next(x for x in rank["runs"] if x["tag"] == "two_buckets")
        assert run["sends"] == run["recvs"] == 2 * 2
    got = _run(port, fleet, "two_buckets")
    sim = TTrainer(engine="sim", protocol=TProto(**EG), loss_fn=_dummy_loss, num_workers=W,
                   mesh_cfg=_mesh(TMesh, fleet), device="cpu")
    stack = _two_buckets(ref, fleet)
    for i, r in enumerate((0, 1)):
        oracle = sim.gossip_exchange(stack, ref[f"{fleet}/active"], r)
        np.testing.assert_allclose(got["rounds"][i]["w"], oracle["w"].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["rounds"][i]["b"].astype(np.float32),
                                   oracle["b"].float().numpy(), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# 20-step trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(TRAJ))
def test_trajectory_matches_reference_dist_engine(ref, port, case):
    """Theta and velocity of every worker after 20 steps: rtol 1e-4, atol
    1e-5 (XLA and ATen sum the model's dot products and the fleet means in
    different orders; momentum carries each ulp forward). fired,
    comm_round and comm_bytes bit-equal to the reference, per step, on
    every rank; the fleet-mean loss within rtol 1e-4."""
    fleet, pkw, codec, fused = TRAJ[case]
    got = _run(port, fleet, case)
    tol = dict(rtol=1e-4, atol=1e-5)
    values = case not in FREE_RUN_COUNTERS_ONLY
    assert values or case in LOCKSTEP
    for k in ("theta", "velocity") if values else ():
        a, b = got[k]["float32"], ref[f"traj/{case}/{k}"]
        if codec != "q8":
            np.testing.assert_allclose(a, b, **tol, err_msg=k)
            continue
        # q8 rounds stochastically: where the ulp-level drift between the
        # packages moves some x/scale + u across an integer, one int8
        # value flips and the element then differs by a fraction of one
        # quantization step (the lockstep test below shows the wire itself
        # is exact). So: every element within the tolerance or within one
        # quantization step, the largest scale its block had on any wire
        # of the run.
        off = ~np.isclose(a, b, **tol)
        q = _q8_step(ref[f"traj/{case}/steps_theta"])
        assert np.all(np.abs(a - b)[off] <= q[np.nonzero(off)[1]]), k
    fired = [bool(f) for f in ref[f"traj/{case}/fired"]]
    for rank in port[fleet]:
        run = next(x for x in rank["runs"] if x["tag"] == case)
        assert run["fired"] == fired
        assert run["comm_round"] == [int(r) for r in ref[f"traj/{case}/comm_round"]]
        assert run["comm_bytes"] == [float(b) for b in ref[f"traj/{case}/comm_bytes"]]
        assert run["loss"] == got["loss"]          # one fleet mean on every rank
        pairwise = tregistry.resolve(TProto(**pkw)).pairwise
        assert run["sends"] == run["recvs"] == (sum(fired) if pairwise else 0)
        assert all(v == 0 for v in run["launches"].values())    # CPU: plain versions
    if values:
        np.testing.assert_allclose(got["loss"], ref[f"traj/{case}/loss"], rtol=1e-4)
    # the wire per exchange and worker (per device on a sharded plane)
    assert got["wire"] == int(ref[f"traj/{case}/wire"])
    if case.startswith("elastic") or case in ("clipped", "trimmed"):
        assert 0 < sum(fired) < STEPS
    if case in SHARD:
        assert got["theta"]["float32"].shape[1] % (SHARD[case] * 512) == 0


@pytest.mark.parametrize("tag", sorted(ANCHORS))
def test_inert_shard_and_recording_runs_are_bit_exact(ref, port, tag):
    """ShardConfig(), ObsConfig() and a recording ObsConfig on the dist
    engine: theta, velocity and every per-step metric bit-equal to the
    plain run's on every rank. The recording: rank 0 alone records, its
    rows hold exactly
    the core step keys, its trace validates in both packages' schema with
    one exchange event per active initiator of the host schedule, each
    carrying the static wire, and the report's comm_bytes total is the host
    account."""
    from repro.obs import schema as jschema
    from repro_torch.obs import report, schema
    fleet = TRAJ[ANCHOR_OF][0]
    want, got = _run(port, fleet, ANCHOR_OF), _run(port, fleet, tag)
    for k in ("theta", "velocity"):
        assert got[k]["float32"].tobytes() == want[k]["float32"].tobytes(), k
    for rank in port[fleet]:
        a = next(x for x in rank["runs"] if x["tag"] == ANCHOR_OF)
        b = next(x for x in rank["runs"] if x["tag"] == tag)
        for k in ("loss", "fired", "comm_round", "comm_active", "comm_bytes"):
            assert a[k] == b[k], (rank["rank"], k)
        assert set(b["keys"]) == schema.CORE_STEP_KEYS
        assert ("events" in b) == (tag == "anchor_obs" and rank["rank"] == 0)
    if tag != "anchor_obs":
        return
    events, rows = got["events"], got["rows"]
    from repro_torch.obs import TraceRecorder
    rec = TraceRecorder()
    rec.events = events
    doc = rec.perfetto(num_workers=4)
    assert schema.validate_trace(doc) == [] and jschema.validate_trace(doc) == []
    ex = [e for e in events if e["ev"] == "exchange"]
    assert ex and all(e["wire_bytes"] == float(got["wire"]) and e["peer"] != e["worker"]
                      for e in ex)
    assert len(ex) == sum(got["comm_active"])
    assert [e["step"] for e in events if e["ev"] == "compute"] == list(range(STEPS))
    assert [r["step"] for r in rows] == list(range(STEPS))
    assert report.totals(rows)["comm_bytes"] == got["comm_bytes"][-1]


def _q8_step(steps_theta, block=512):
    """Per-element quantization step bound: the largest amax/127 of the
    element's block over every worker and step of the run."""
    T, W, n = steps_theta.shape
    nb = -(-n // block)
    pad = np.zeros((T, W, nb * block), np.float32)
    pad[..., :n] = np.abs(steps_theta)
    scale = pad.reshape(T, W, nb, block).max(axis=(0, 1, 3)) * np.float32(1.0 / 127.0)
    return np.repeat(scale, block)[:n]


@pytest.mark.parametrize("case", LOCKSTEP)
def test_lockstep_step_matches_reference_dist_engine(ref, port, case):
    """Every step from the reference's state: theta and velocity after the
    step within rtol 1e-4 / atol 1e-5 on every rank and every step (the q8
    wire of equal thetas is equal, so no int8 value flips here)."""
    fleet = TRAJ[case][0]
    for rank in port[fleet]:
        steps = rank["lockstep"][case]
        assert len(steps) == STEPS
        for i, row in enumerate(steps):
            for k, (n_off, worst) in row.items():
                assert n_off == 0, (rank["rank"], i, k, n_off, worst)
    fired = sum(bool(f) for f in ref[f"traj/{case}/fired"])
    assert fired > 0


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def test_dist_checkpoint_is_the_reference_s_file_and_resumes_bit_exactly(ref, port):
    """The port's dist checkpoint (rank 0 writes the whole [8, total] plane
    after a gather) has the reference dist facade's entries, dtypes and
    shapes, the same FlatSpec manifest and the same metadata keys (plus the
    caller's); loaded back, every rank's row and the next 3 steps equal the
    uninterrupted run's bit for bit, metrics included."""
    fleet = TRAJ[CKPT_CASE][0]
    with np.load(ref["ckpt_path"]) as z:
        want = {k: (list(z[k].shape), z[k].dtype.str) for k in z.files}
    with open(ref["ckpt_path"] + ".meta.json") as f:
        jmeta = json.load(f)
    runs = [next(r for r in rk["runs"] if r["tag"] == "resume") for rk in port[fleet]]
    assert runs[0]["entries"] == want
    assert set(want) == {"theta::float32", "opt::mu::float32", "opt::step", "step"}
    tmeta = runs[0]["meta"]
    assert tmeta["flat_spec"] == jmeta["flat_spec"]
    assert set(tmeta) == set(jmeta) == {"protocol", "format", "flat_spec", "schedule",
                                        "comm_bytes", "step"}
    assert set(tmeta["schedule"]) == set(jmeta["schedule"])
    for rank, r in enumerate(runs):
        assert r["loaded_diff"] == [] and r["final_diff"] == [], (rank, r)
        assert r["metrics_equal"], rank


def test_group_coordinates_and_consensus(tmp_path):
    """Ranks are row-major over (pod, worker); the consensus diagnostics
    reduce over the group and equal the reference's on the whole stack."""
    import jax.numpy as jnp
    from repro.core import consensus as jcons
    mcfg = TMesh(data=2, model=1, pods=2, workers_per_pod=2)
    rng = np.random.RandomState(4)
    stack = {"a": rng.randn(4, 5, 3).astype(np.float32), "b": rng.randn(4, 7).astype(np.float32)}
    res = tmesh.spawn_workers(helpers.consensus_rows, mcfg, "cpu", args=(stack,),
                              timeout_s=30, join_timeout_s=120, rendezvous_dir=str(tmp_path))
    for rank, r in enumerate(res):
        assert (r["rank"], r["pod"], r["worker"], r["world"]) == (rank, rank // 2, rank % 2, 4)
        agg = jcons.aggregate({k: jnp.asarray(v) for k, v in stack.items()})
        for k in stack:
            np.testing.assert_allclose(r["aggregate"][k], np.asarray(agg[k]), rtol=1e-6,
                                       atol=1e-6)
        div = jcons.divergence_metrics({k: jnp.asarray(v) for k, v in stack.items()})
        for k, v in div.items():
            np.testing.assert_allclose(r["divergence"][k], float(v), rtol=1e-5)
        np.testing.assert_allclose(r["total_sum"], float(jcons.total_sum(
            {k: jnp.asarray(v) for k, v in stack.items()})), rtol=1e-5)


def test_a_failing_rank_fails_the_group(tmp_path):
    import time
    t0 = time.monotonic()
    with pytest.raises(Exception, match="failed on purpose"):
        tmesh.spawn_workers(helpers.raise_on_rank, TMesh(data=2, model=1, pods=1,
                                                         workers_per_pod=2),
                            "cpu", args=(1,), timeout_s=30, join_timeout_s=60,
                            rendezvous_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def test_a_hanging_group_is_killed_at_its_timeout(tmp_path):
    with pytest.raises(TimeoutError, match="still running"):
        tmesh.spawn_workers(helpers.sleep_forever, TMesh(data=2, model=1, pods=1,
                                                         workers_per_pod=2),
                            "cpu", timeout_s=30, join_timeout_s=5,
                            rendezvous_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_sharded_or_tensor_parallel_mesh_refuses():
    """Tensor parallelism (model > 1) is refused for any group (slice 7b).
    The fsdp factor is the sharded plane's: a group takes it, and the mesh
    must give fsdp = n_shards, 1 without a ShardConfig, as the reference's
    DistTrainer requires."""
    tp = TMesh(data=4, model=2, pods=1, workers_per_pod=4)
    with pytest.raises(NotImplementedError, match="slice 7b"):
        tmesh.check_mesh(tp)
    with pytest.raises(NotImplementedError):
        tmesh.WorkerGroup(0, tp, "cpu")
    fsdp2 = TMesh(data=8, model=1, pods=1, workers_per_pod=4)
    assert tmesh.WorkerGroup(0, fsdp2, "cpu").world == 4
    tmesh.check_shard_mesh(fsdp2, TShard(n_shards=2))
    tmesh.check_shard_mesh(TMesh(data=4, model=1, pods=1, workers_per_pod=4))
    for shard, n in ((None, 1), (TShard(n_shards=4), 4)):
        with pytest.raises(ValueError, match=f"n_shards={n}.*mesh"):
            tmesh.check_shard_mesh(fsdp2, shard)
    with pytest.raises(ValueError, match="not in mesh axes"):
        tmesh.check_shard_mesh(fsdp2, TShard(n_shards=2, axes=("tensor",)))


def test_dist_facade_refusals():
    from types import SimpleNamespace
    from repro_torch.common.config import FaultConfig, OptimizerConfig
    mcfg = TMesh(data=2, model=1, pods=1, workers_per_pod=2)
    group = SimpleNamespace(rank=0, world=2, mesh_cfg=mcfg, device=torch.device("cpu"))
    kw = dict(engine="dist", protocol=TProto(comm_probability=0.5), loss_fn=_dummy_loss,
              device="cpu")
    with pytest.raises(ValueError, match="does not support fault injection"):
        TTrainer(**kw, group=group, faults=FaultConfig(fault_model="drop", fault_rate=0.1))
    from repro_torch.common.config import FleetConfig
    with pytest.raises(ValueError, match="no fleet plane"):
        TTrainer(**kw, group=group, fleet=FleetConfig())
    with pytest.raises(ValueError, match="n_shards=2.*mesh"):
        TTrainer(**kw, group=group, shard=TShard(n_shards=2))
    with pytest.raises(ValueError, match="pairwise"):
        TTrainer(**dict(kw, protocol=TProto(method="allreduce")), group=group,
                 shard=TShard(n_shards=2))
    with pytest.raises(ValueError, match="requires loss_fn and group"):
        TTrainer(**kw)
    with pytest.raises(ValueError, match="NAG"):
        TTrainer(**kw, group=group, optimizer=OptimizerConfig(name="sgd"))
    with pytest.raises(ValueError, match="num_workers"):
        TTrainer(**kw, group=group, num_workers=3)
    with pytest.raises(ValueError, match="group's rank"):
        TTrainer(**dict(kw, device="meta"), group=group)
    tr = TTrainer(**kw, group=group)
    assert tr.device == group.device
    assert tr.num_workers == 2 and tr.num_gossip_rounds == 1
    assert np.array_equal(tr.matching_partners(0), [1, 0])
    with pytest.raises(RuntimeError, match="CUDA is not available") if not \
            torch.cuda.is_available() else pytest.raises(ValueError):
        TTrainer(engine="dist", protocol=TProto(comm_probability=0.5), loss_fn=_dummy_loss,
                 group=group)
