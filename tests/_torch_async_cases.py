"""Shared pieces of tests/test_torch_hetero.py and tests/test_torch_fleet.py:
the reference tests' Gaussian-cluster problem (W workers, 32 points of 10
features in 3 classes), an MLP of hidden 24 and depth 2 in both packages
from the same weights, and the lockstep machinery that starts the port from
the reference's pre-window state with the reference's draws injected."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import GossipTrainer as JTrainer
from repro.common import config as jcfg
from repro.models import simple as jsimple
from repro_torch.api import GossipTrainer as TTrainer
from repro_torch.common import config as tcfg
from repro_torch.models import simple as tsimple

IN, HID, DEPTH, NCLS, N = 10, 24, 2, 3, 32
OPT = dict(name="nag", learning_rate=0.05, momentum=0.9)
# ProtocolState fields compared exactly (integers) and to f32 rounding
INT_FIELDS = ("comm_rounds", "comm_units", "worker_steps", "stale_steps", "stale_events",
              "wire_dropped", "wire_corrupt", "exch_timeouts", "exch_retries",
              "flow_skipped", "chunk_units")
F32_FIELDS = ("comm_bytes", "clocks", "tokens")
FIELDS = INT_FIELDS + F32_FIELDS + ("stale_time",)


def problem(W, seed=0):
    """(x f32 [W, N, IN], y int [W, N]) numpy: the reference tests' clusters."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(NCLS, IN) * 2
    y = rng.randint(0, NCLS, (W, N)).astype(np.int32)
    x = (protos[y] + rng.randn(W, N, IN)).astype(np.float32)
    return x, y


def _jloss(p, x, y):
    return jsimple.xent_loss(jsimple.mlp_logits(p, x), y)


def _tloss(p, x, y):
    return tsimple.xent_loss(tsimple.mlp_logits(p, x), y)


@functools.lru_cache(maxsize=None)
def jparams():
    return jsimple.init_mlp(jax.random.PRNGKey(0), IN, HID, DEPTH, NCLS)[0]


def tparams():
    return tsimple.params_from_jax(jax.tree.map(np.asarray, jparams()), "cpu")


def _cfg(mod, name, kw):
    return None if kw is None else getattr(mod, name)(**kw)


def trainers(engine, W, proto, hetero=None, faults=None, fleet=None, fused=True, codec=None,
             opt=None, shard=None, obs=None):
    """(reference facade, port facade) built from the same keyword dicts."""
    out = []
    for mod, Tr, loss, extra in ((jcfg, JTrainer, _jloss, {}),
                                 (tcfg, TTrainer, _tloss, {"device": "cpu"})):
        out.append(Tr(engine=engine, protocol=mod.ProtocolConfig(**proto),
                      optimizer=mod.OptimizerConfig(**(opt or OPT)), loss_fn=loss,
                      num_workers=W,
                      fused_update=fused, codec=codec,
                      hetero=_cfg(mod, "HeteroConfig", hetero),
                      faults=_cfg(mod, "FaultConfig", faults),
                      fleet=_cfg(mod, "FleetConfig", fleet),
                      shard=_cfg(mod, "ShardConfig", shard),
                      obs=_cfg(mod, "ObsConfig", obs), **extra))
    return out


def init_states(jtr, ttr):
    return jtr.init_state(0, params=jparams()), ttr.init_state(0, params=tparams())


def snap(jst):
    """Numpy copies of a reference state's arrays (its step donates them)."""
    out = {"theta": {b: np.array(v) for b, v in jst.theta.items()},
           "mu": {b: np.array(v) for b, v in jst.opt.mu.items()},
           "step": np.array(jst.step), "opt_step": np.array(jst.opt.step)}
    out["proto"] = {f: np.array(getattr(jst.proto, f)) for f in FIELDS
                    if getattr(jst.proto, f) is not None}
    res = getattr(jst.comm, "residual", None)
    out["residual"] = None if res is None else {b: np.array(v) for b, v in res.items()}
    return out


def ref_draws(jtr, jst):
    """The gate and peers the reference's next step consumes (pure in its
    pre-step key)."""
    gate, peers = jtr._backend.sim._draw_fn(jnp.array(jst.key), jnp.array(jst.step))
    return np.array(gate), np.array(peers)


def load_into_port(ttr, tst, pre, jtr=None):
    """The port's state set to the reference's snapshot ``pre`` (in place
    where the port keeps resident buffers), and the async engine's host
    clocks to the reference's."""
    for b in tst.theta:
        tst.theta[b].copy_(torch.from_numpy(pre["theta"][b]))
        tst.opt.mu[b].copy_(torch.from_numpy(pre["mu"][b]))
    upd = {f: torch.from_numpy(v.copy()) for f, v in pre["proto"].items()
           if getattr(tst.proto, f) is not None}
    tst = tst.replace(step=torch.from_numpy(pre["step"].copy()),
                      opt=tst.opt._replace(step=torch.from_numpy(pre["opt_step"].copy())),
                      proto=tst.proto._replace(**upd))
    if pre["residual"] is not None:
        for b in tst.comm.residual:
            tst.comm.residual[b].copy_(torch.from_numpy(pre["residual"][b]))
    if jtr is not None and hasattr(jtr._backend.sim, "clocks"):
        ttr.sim.anchor(jtr._backend.sim.clocks, jtr._backend.sim.steps_done)
    return tst


def compare(tst, post, tol, what=""):
    """The port's state against the reference's snapshot ``post``: theta,
    velocity and a top-k residual within ``tol``, integer counters exact,
    the f32 fields (bytes, clocks, tokens) bit-equal, stale_time to f32
    summation order."""
    for b in tst.theta:
        np.testing.assert_allclose(tst.theta[b].numpy(), post["theta"][b], **tol,
                                   err_msg=f"{what} theta {b}")
        np.testing.assert_allclose(tst.opt.mu[b].numpy(), post["mu"][b], **tol,
                                   err_msg=f"{what} velocity {b}")
    for f, want in post["proto"].items():
        got = getattr(tst.proto, f)
        assert got is not None, f"{what} {f} missing in the port"
        got = got.numpy()
        if f == "stale_time":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), (what, f, got, want)
    assert int(tst.step) == int(post["step"])
    if post["residual"] is not None:
        for b in tst.comm.residual:
            np.testing.assert_allclose(tst.comm.residual[b].numpy(), post["residual"][b], **tol,
                                       err_msg=f"{what} residual {b}")


def lockstep(jtr, ttr, W, windows, tol, check=None):
    """Run ``windows`` reference steps (async: event windows); before each,
    load the reference's pre-step state (and host clocks) into the port and
    inject its draws; after each, compare states and metrics. ``check(when,
    jtr, ttr, i)`` runs before ("pre") and after ("post") each. Returns the
    window sizes seen (None on the sim engine) and the port's last state."""
    x, y = problem(W)
    jst, tst = init_states(jtr, ttr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    sizes = []
    for i in range(windows):
        pre = snap(jst)
        draws = ref_draws(jtr, jst)
        tst = load_into_port(ttr, tst, pre, jtr)
        if check is not None:
            check("pre", jtr, ttr, i)
        jst, jm = jtr.step(jst, (jnp.asarray(x), jnp.asarray(y)))
        tst, tm = ttr.step(tst, (xt, yt), draws=tuple(map(torch.from_numpy, draws)))
        post = snap(jst)
        compare(tst, post, tol, f"window {i}")
        if "window_size" in jm:
            assert tm["window_size"] == jm["window_size"]
            assert tm["virtual_time"] == jm["virtual_time"]
            assert np.array_equal(ttr.sim.clocks, jtr._backend.sim.clocks)
            assert np.array_equal(ttr.sim.steps_done, jtr._backend.sim.steps_done)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tm["loss_max"]), float(jm["loss_max"]), rtol=1e-5,
                                   atol=1e-6)
        if check is not None:
            check("post", jtr, ttr, i)
        sizes.append(tm.get("window_size"))
    return sizes, tst
