"""The dist engine on the reduced TinyLlama against the reference's:
``grad_accum`` and ``model > 1``.

The reference runs in one subprocess with 8 fake devices and writes every
case into one .npz; the port runs as gloo groups of 2 and 4 ranks on the
CPU, from the reference's ``init_lm`` parameters on the reference's
batches (one label ignored, in the first microbatch of worker 0's first
step only). Checked:

- ``grad_accum`` A in {2, 4} at W = 2 and 4: the losses, theta and the
  velocity after 4 elastic steps within rtol 1e-4 / atol 1e-5 of the
  reference's dist engine with the same A, ``fired`` / ``comm_round`` /
  ``comm_bytes`` equal;
- its refusals (A < 1, a batch A does not divide, A != 1 off the dist
  engine), each a ValueError before anything runs;
- ``model = 2`` as the reference runs it (the plane replicated over the
  ``model`` devices): the reference's ``test_dist_trainer_protocols_run_and_learn``
  configuration (``data=4, model=2, workers=4``, elastic p 0.5, allreduce
  and easgd tau 2, global batch 8, seq 32, lr 3e-3, 24 steps) learns with
  ``comm_bytes > 0``; six elastic steps are within rtol 1e-4 / atol 1e-5
  of the reference's own ``model = 2`` run, and bit-equal to the port's
  ``model = 1`` run;
- ``fsdp > 1`` without a sharded plane is taken; the CLI's
  ``--production-mesh`` runs (in tests/test_torch_train_cli.py)."""
import json
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common.config import MeshConfig as TMesh  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

import _torch_dist_helpers as helpers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama_1_1b"
OPT = dict(name="nag", learning_rate=3e-3, momentum=0.9)
EG = dict(method="elastic_gossip", comm_probability=0.5, moving_rate=0.5)
SEQ = 32
GA_STEPS, GA_PW = 4, 4
# the reference's protocols test: data=4, model=2, 4 workers, 2 rows each
TP_MESH = dict(data=4, model=2, pods=1, workers_per_pod=4)
TP_STEPS, TP_PW, LEARN_STEPS = 6, 2, 24
PROTOCOLS = {"elastic": EG, "allreduce": dict(method="allreduce", moving_rate=0.5),
             "easgd": dict(method="easgd", comm_period=2, moving_rate=0.5)}
# case -> (W, A): the reference's mesh has all 8 fake devices (fsdp = 8 / W)
GA = {f"ga{A}_w{W}": (W, A) for W in (2, 4) for A in (2, 4)}
TOL = dict(rtol=1e-4, atol=1e-5)

REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.api import GossipTrainer
from repro.common.config import MeshConfig, OptimizerConfig, ProtocolConfig
from repro.configs import get_reduced
from repro.launch.mesh import make_worker_mesh
from repro.models import transformer as tr

spec = json.loads(sys.argv[3])
cfg = get_reduced(spec["arch"])
with np.load(sys.argv[2]) as z:
    inputs = {k: z[k] for k in z.files}
params = {}
for key, v in inputs.items():
    if key.startswith("params/"):
        node = params
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
_, axes = tr.abstract_lm(cfg)
out = {}

def run(tag, mcfg, proto, steps, pw, A=1):
    W = mcfg.num_workers
    toks, labels = inputs[tag + "/tokens"], inputs[tag + "/labels"]
    trainer = GossipTrainer(engine="dist", protocol=ProtocolConfig(**proto),
                            optimizer=OptimizerConfig(**spec["opt"]), mesh=make_worker_mesh(mcfg),
                            mesh_cfg=mcfg, model_cfg=cfg, init_fn=lambda key: params,
                            params_axes=axes, global_batch=W * pw, seq_len=spec["seq"],
                            grad_accum=A)
    st = trainer.init_state(0)
    rec = {k: [] for k in ("loss", "fired", "comm_round", "comm_bytes")}
    for i in range(steps):
        st, m = trainer.step(st, {"tokens": jnp.asarray(toks[i]), "labels": jnp.asarray(labels[i])})
        for k in rec:
            rec[k].append(float(m[k]))
    for k, v in rec.items():
        out[f"{tag}/{k}"] = np.asarray(v)
    out[tag + "/theta"] = np.asarray(st.theta["float32"])
    out[tag + "/velocity"] = np.asarray(st.opt.mu["float32"])

for tag, (W, A) in spec["ga"].items():
    run(tag, MeshConfig(data=8, model=1, pods=1, workers_per_pod=W), spec["eg"],
        spec["ga_steps"], spec["ga_pw"], A)
if spec["model2"]:
    run("model2", MeshConfig(**spec["tp_mesh"]), spec["eg"], spec["tp_steps"], spec["tp_pw"])
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


def _inputs():
    """The reference's ``init_lm`` parameters and every run's batches
    ``[steps, W, pw, seq]``: the reference's protocols test's token stream,
    one label ignored in worker 0's first step (its first microbatch)."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.data.synthetic import make_lm_tokens
    from repro.models import transformer as jtr
    cfg = jget_reduced(ARCH)
    out = {}

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, prefix + k + "/")
            else:
                out[prefix + k] = np.asarray(v)
    flat(jtr.init_lm(jax.random.PRNGKey(0), cfg)[0], "params/")
    stream = make_lm_tokens(400_000, cfg.vocab_size, 0)

    def batches(tag, steps, W, pw):
        shard, n = len(stream) // W, pw * (SEQ + 1)
        arr = np.stack([np.stack([stream[w * shard + (i * n) % (shard - n):][:n]
                                  .reshape(pw, SEQ + 1) for w in range(W)])
                        for i in range(steps)])
        out[tag + "/tokens"] = arr[..., :-1].astype(np.int32)
        out[tag + "/labels"] = labels = arr[..., 1:].astype(np.int32)
        labels[0, 0, 0, 3] = -1
    for tag, (W, _) in GA.items():
        batches(tag, GA_STEPS, W, GA_PW)
    batches("model2", TP_STEPS, 4, TP_PW)
    batches("learn", LEARN_STEPS, 4, TP_PW)
    return out


def _params(inputs):
    out = {}
    for key, v in inputs.items():
        if key.startswith("params/"):
            node = out
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def _data(inputs, tag):
    return {"tokens": inputs[tag + "/tokens"], "labels": inputs[tag + "/labels"]}


def _port_job(inputs, W):
    runs = [dict(tag=tag, data=tag, mesh=dict(data=8, model=1, pods=1, workers_per_pod=W),
                 protocol=EG, steps=GA_STEPS, grad_accum=A)
            for tag, (w, A) in GA.items() if w == W]
    data = {tag: _data(inputs, tag) for tag, (w, _) in GA.items() if w == W}
    if W == 4:
        runs.append(dict(tag="model2", data="model2", mesh=TP_MESH, protocol=EG,
                         steps=TP_STEPS))
        data["model2"], data["learn"] = _data(inputs, "model2"), _data(inputs, "learn")
        for name, proto in PROTOCOLS.items():
            runs.append(dict(tag=f"learn_{name}", data="learn", mesh=TP_MESH, protocol=proto,
                             steps=LEARN_STEPS))
        runs.append(dict(tag="model1", data="model2", mesh=dict(TP_MESH, model=1),
                         protocol=EG, steps=TP_STEPS))
    return dict(params=_params(inputs), opt=OPT, data=data, runs=runs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's cases, {W: the port's rank 0 results}). The
    reference runs in two subprocesses with 8 fake devices each (the W = 2
    cases; the W = 4 cases and model = 2) while the port's gloo groups of 2
    and 4 ranks run, each spawned from its own thread."""
    tmp = tmp_path_factory.mktemp("dist_lm")
    inputs = _inputs()
    np.savez(str(tmp / "inputs.npz"), **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    subs = []
    for W in (2, 4):
        spec = dict(arch=ARCH, opt=OPT, eg=EG, seq=SEQ, ga_steps=GA_STEPS, ga_pw=GA_PW,
                    ga={t: c for t, c in GA.items() if c[0] == W}, model2=W == 4,
                    tp_mesh=TP_MESH, tp_steps=TP_STEPS, tp_pw=TP_PW)
        path = str(tmp / f"ref{W}.npz")
        subs.append((path, subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), path, str(tmp / "inputs.npz"),
             json.dumps(spec)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)))
    port = {}

    def group(W):
        port[W] = tmesh.spawn_workers(helpers.lm_runs, TMesh(data=W, model=1, pods=1,
                                                             workers_per_pod=W),
                                      "cpu", args=(_port_job(inputs, W),), timeout_s=60,
                                      join_timeout_s=300, rendezvous_dir=str(tmp))[0]
    threads = [threading.Thread(target=group, args=(W,)) for W in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(port) == [2, 4], "a port group failed"
    ref = {}
    for path, sub in subs:
        so, se = sub.communicate(timeout=400)
        assert sub.returncode == 0 and "REF_OK" in so, f"{so}\n{se}"
        with np.load(path) as z:
            ref.update({k: z[k] for k in z.files})
    return ref, port


def _same_counters(got, ref, tag):
    for k in ("fired", "comm_round", "comm_bytes"):
        np.testing.assert_array_equal(np.asarray(got[k]), ref[f"{tag}/{k}"], err_msg=k)


@pytest.mark.parametrize("tag", sorted(GA))
def test_grad_accum_trajectory_matches_reference(runs, tag):
    ref, port = runs
    W, A = GA[tag]
    got = port[W][tag]
    _same_counters(got, ref, tag)
    np.testing.assert_allclose(got["loss"], ref[f"{tag}/loss"], **TOL)
    np.testing.assert_allclose(got["theta"], ref[f"{tag}/theta"], **TOL)
    np.testing.assert_allclose(got["velocity"], ref[f"{tag}/velocity"], **TOL)


def test_model2_matches_reference_s_model2_run(runs):
    ref, port = runs
    got = port[4]["model2"]
    _same_counters(got, ref, "model2")
    np.testing.assert_allclose(got["loss"], ref["model2/loss"], **TOL)
    np.testing.assert_allclose(got["theta"], ref["model2/theta"], **TOL)
    np.testing.assert_allclose(got["velocity"], ref["model2/velocity"], **TOL)


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_model2_protocols_run_and_learn(runs, name):
    port = runs[1]
    got = port[4][f"learn_{name}"]
    assert got["loss"][-1] < got["loss"][0], got["loss"]
    assert got["comm_bytes"][-1] > 0


def test_model2_is_bit_equal_to_model1(runs):
    port = runs[1]
    a, b = port[4]["model2"], port[4]["model1"]
    assert a["loss"] == b["loss"] and a["fired"] == b["fired"]
    assert np.array_equal(a["theta"], b["theta"])
    assert np.array_equal(a["velocity"], b["velocity"])


def _fake_group(mesh):
    return SimpleNamespace(rank=0, world=mesh.num_workers, mesh_cfg=mesh,
                           device=torch.device("cpu"))


def test_grad_accum_refusals():
    cfg = get_reduced(ARCH)
    mesh = TMesh(data=2, model=1, pods=1, workers_per_pod=2)
    kw = dict(protocol=TProto(**EG), optimizer=TOpt(**OPT), device="cpu")
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="grad_accum"):
            TTrainer(engine="dist", model_cfg=cfg, group=_fake_group(mesh), grad_accum=bad,
                     **kw)
    for engine in ("sim", "async"):
        with pytest.raises(ValueError, match="grad_accum=2 is the dist engine's"):
            TTrainer(engine=engine, loss_fn=lambda p, x, y: x.sum(), num_workers=2,
                     grad_accum=2, **kw)
    trainer = TTrainer(engine="dist", model_cfg=cfg, group=_fake_group(mesh), grad_accum=2,
                       init_fn=lambda g: {"w": torch.zeros(3)}, **kw)
    state = trainer.init_state(0)
    toks = torch.zeros((3, SEQ), dtype=torch.int32)
    with pytest.raises(ValueError, match="grad_accum=2 does not divide the rank's batch of 3"):
        trainer.step(state, (toks, toks))


def test_meshes_with_fsdp_or_model_and_no_shard_are_taken():
    """The plane is replicated over fsdp and model without a ShardConfig,
    as the reference's DistTrainer takes any host mesh."""
    cfg = get_reduced(ARCH)
    for mesh in (TMesh(data=8, model=1, pods=1, workers_per_pod=2),
                 TMesh(data=4, model=2, pods=1, workers_per_pod=4),
                 TMesh(data=16, model=16, pods=2, workers_per_pod=4)):
        tmesh.check_mesh(mesh)
        tmesh.check_shard_mesh(mesh)
        tr = TTrainer(engine="dist", model_cfg=cfg, group=_fake_group(mesh), device="cpu",
                      protocol=TProto(**EG), optimizer=TOpt(**OPT))
        assert tr.dist.W == mesh.num_workers
