"""The port's training CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``): the token stream bit for bit, the
flags, ``TrainConfig``'s defaults, the refusals, the printed records of a
run from the reference's initial params, a checkpoint written by the CLI
loaded in both packages, and the CLI training ``tinyllama_1_1b --reduced``
on the sim, async and dist engines (``--device cpu``)."""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common.config import OptimizerConfig as JOpt  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import train as jcli  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.common.config import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import train as tcli  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama_1_1b"


@pytest.mark.parametrize("W", [1, 2, 8])
def test_lm_batches_are_the_reference_s_bit_for_bit(W):
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tb = tcli.lm_batches(cfg, W, 3, 16, seed=4)
    jb = jcli.lm_batches(jcfg, W, 3, 16, seed=4)
    for _ in range(3):
        t, j = next(tb), next(jb)
        assert sorted(t) == sorted(j) == ["labels", "tokens"]
        for k in t:
            assert t[k].dtype == torch.int32 and tuple(t[k].shape) == (W, 3, 16)
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


RUN_FIELDS = {"steps", "seed", "param_dtype", "compute_dtype", "checkpoint_every",
              "checkpoint_dir", "log_every", "data_skew"}


def test_train_config_defaults_equal_the_reference_s_field_by_field():
    """Every field of the port's TrainConfig takes the reference's default.
    The eight run fields, which neither package's launcher reads, are left
    out; both launchers take steps, seed, the checkpoint directory and the
    logging cadence as ``run`` arguments, with the same defaults."""
    import inspect
    t, j = TTrainConfig(), JTrainConfig()
    names = {f.name for f in dataclasses.fields(TTrainConfig)}
    assert {f.name for f in dataclasses.fields(JTrainConfig)} - names == RUN_FIELDS
    for f in dataclasses.fields(JTrainConfig):
        if f.name not in names:
            continue
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
        else:
            assert tv == jv, f.name
    tp = inspect.signature(tcli.run).parameters
    jp = inspect.signature(jcli.run).parameters
    for n in ("steps", "seed", "checkpoint_dir", "log_every"):
        assert n in tp and tp[n].default == jp[n].default, n


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch):
    """The reference builds its parser inside main(): stop at parse_args."""
    def stop(self, *a, **kw):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as e:
        jcli.main()
    monkeypatch.undo()
    return e.value.args[0]


def test_every_flag_of_the_reference_with_its_name_default_and_choices(monkeypatch):
    ref = {a.dest: a for a in _reference_parser(monkeypatch)._actions if a.dest != "help"}
    port = {a.dest: a for a in tcli.parser()._actions if a.dest != "help"}
    assert set(port) - set(ref) == {"device"}
    assert port["device"].default == "cuda"
    for k, a in ref.items():
        b = port[k]
        assert (b.option_strings, b.default, b.type, b.required) == \
            (a.option_strings, a.default, a.type, a.required), k
        assert (a.choices is None) == (b.choices is None), k
        if a.choices is not None:
            assert set(b.choices) == set(a.choices), k
    with pytest.raises(SystemExit):
        tcli.parser().parse_args(["--arch", ARCH, "--method", "no_such_protocol"])


# (engine, kwargs) that both CLIs refuse with ValueError before training
REFUSALS = {
    "dist_partition": ("dist", dict(partition=2)),
    "dist_flow_control": ("dist", dict(flow_control="token_account")),
    "dist_host_plane": ("dist", dict(plane="host")),
    "dist_faults": ("dist", dict(fault_model="drop", fault_rate=0.1)),
    "dist_delay": ("dist", dict(delay_model="lognormal", delay=0.5)),
    "sim_memory": ("sim", dict(workers=10 ** 6)),
    "async_memory": ("async", dict(workers=10 ** 6)),
    "host_plane_memory": ("async", dict(workers=10 ** 8, plane="host")),
}


def _run_kw(**kw):
    base = dict(reduced=True, steps=2, method="elastic_gossip", p=0.5, tau=0, alpha=0.5,
                workers=2, global_batch=4, seq=16, lr=3e-3, engine="sim")
    base.update(kw)
    return base


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_same_cases_are_refused_in_both(case):
    engine, kw = REFUSALS[case]
    with pytest.raises(ValueError):
        jcli.run(ARCH, **_run_kw(engine=engine, **kw))
    with pytest.raises(ValueError):
        tcli.run(ARCH, **_run_kw(engine=engine, device="cpu", **kw))


@pytest.mark.parametrize("flag", ["production_mesh", "multi_pod"])
def test_tensor_parallel_meshes_are_refused_naming_the_roadmap(flag):
    """--production-mesh runs the reference's MeshConfig(data=16, model=16,
    pods=2 if --multi-pod else 1, workers_per_pod=--workers) on the dist
    engine, one process per worker (2, or 2 pods x 2); --multi-pod alone,
    which the reference ignores, is refused naming --production-mesh, and
    so is a --shard that is not fsdp x model."""
    kw = _run_kw(engine="dist", device="cpu", production_mesh=True, multi_pod=flag == "multi_pod")
    if flag == "multi_pod":
        with pytest.raises(ValueError, match="--production-mesh"):
            tcli.run(ARCH, **dict(kw, production_mesh=False))
    with pytest.raises(ValueError, match="n_shards=2.*mesh"):
        tcli.run(ARCH, **dict(kw, shard=2))
    ranks, history = tcli.run(ARCH, **kw)
    assert len(ranks) == (4 if flag == "multi_pod" else 2)
    assert len(history) == 2 and all(np.isfinite(r["loss"]) for r in history)


def _records(out: str):
    return [json.loads(line) for line in out.splitlines() if line.startswith('{"step"')]


def test_run_records_equal_the_reference_s_from_its_initial_params(capsys):
    """allreduce (no draws) on sim, 10 steps from the reference's init_lm:
    the printed records have the same keys and are within rtol 1e-4."""
    kw = _run_kw(method="allreduce", steps=10, log_every=1)
    jcli.run(ARCH, **kw)
    want = _records(capsys.readouterr().out)
    params = jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0),
                                                  jget_reduced(ARCH))[0])
    _, hist = tcli.run(ARCH, device="cpu", params=params, **kw)
    got = _records(capsys.readouterr().out)
    assert got == hist and len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert (g["step"], g["fired"], g["comm_mb"]) == (w["step"], w["fired"], w["comm_mb"])
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["consensus_rel"], w["consensus_rel"], rtol=1e-4,
                                   atol=1e-7)
    assert got[-1]["loss"] < got[0]["loss"]


def test_a_cli_checkpoint_at_step_50_loads_in_both_packages(tmp_path):
    """The port's CLI writes step_50.npz; the reference's facade and the
    port's load it, each to the port's state at step 50 bit for bit."""
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    state, hist = tcli.run(ARCH, device="cpu", checkpoint_dir=str(tmp_path),
                           **_run_kw(steps=50, log_every=50))
    path = str(tmp_path / "step_50.npz")
    proto = dict(method="elastic_gossip", moving_rate=0.5, comm_probability=0.5)
    opt = dict(name="nag", learning_rate=3e-3, momentum=0.9)
    jt = JTrainer(engine="sim", protocol=JProto(**proto), optimizer=JOpt(**opt),
                  loss_fn=lambda p, x, y: jtr.lm_loss(p, jcfg, x, y)[0], num_workers=2,
                  init_fn=lambda k: jtr.init_lm(k, jcfg)[0])
    jstate, jmeta = jt.load_checkpoint(path, jt.init_state(1))
    tt = TTrainer(engine="sim", protocol=TProto(**proto), optimizer=TOpt(**opt),
                  loss_fn=lambda p, x, y: tr.lm_loss(p, cfg, x, y)[0], num_workers=2,
                  device="cpu", init_fn=lambda g: tr.init_lm(g, cfg)[0])
    tstate, tmeta = tt.load_checkpoint(path, tt.init_state(1))
    assert jmeta["arch"] == tmeta["arch"] == ARCH and jmeta["step"] == tmeta["step"] == 50
    assert int(jstate.step) == int(tstate.step) == 50
    for want, j, t in ((state.theta, jstate.theta, tstate.theta),
                       (state.opt.mu, jstate.opt.mu, tstate.opt.mu)):
        np.testing.assert_array_equal(np.asarray(j["float32"]), want["float32"].numpy())
        np.testing.assert_array_equal(t["float32"].numpy(), want["float32"].numpy())
    for f in ("comm_rounds", "comm_units", "comm_bytes"):
        assert np.array_equal(np.asarray(getattr(jstate.proto, f)),
                              getattr(tstate.proto, f).numpy()), f


# the CLI as a user runs it: a fresh interpreter per engine
ENGINE_RUNS = {
    "sim": ["--engine", "sim", "--workers", "4"],
    "async": ["--engine", "async", "--workers", "4"],
    "dist": ["--engine", "dist", "--workers", "2"],
}


@pytest.mark.parametrize("engine", sorted(ENGINE_RUNS))
def test_the_cli_trains_tinyllama_reduced_and_its_loss_falls(engine):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced",
           "--steps", "30", "--p", "0.5", "--lr", "3e-3", "--seq", "32",
           "--device", "cpu"] + ENGINE_RUNS[engine]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = _records(out.stdout)
    assert [r["step"] for r in recs] == [0, 10, 20, 29]
    assert recs[-1]["loss"] < recs[0]["loss"] - 0.3, recs
    assert "trained 30 steps" in out.stdout
    if engine == "async":
        assert all("virtual_time" in r and "window_size" in r for r in recs)
