"""Tensor-parallel serving (``make_serve_program(mesh_cfg=..., group=...)``
with ``model = M > 1``) against the reference's serving program.

The port serves over gloo groups on the CPU: one group of 4 ranks and its
two halves as groups of 2, in f32, on the reference's ``init_lm`` weights.
Checked, at M = 2 and 4:

- reduced TinyLlama (heads and kv heads split; at M = 4 the kv heads
  whole, each rank keeping the one its q heads read), reduced Gemma2 (kv
  heads kept whole at M = 4, attention and final softcaps, local windows)
  and reduced Granite-20B (one kv head; at M = 4 its 6 heads whole):
  prefill, 8 decode steps and 8 ``decode_slots`` steps with a
  ``kv_start``, the logits of every step within rtol 1e-4 / atol 1e-5 of
  the reference's ``make_serve_program`` on a one-device host mesh, and
  every step's greedy token (argmax) equal (the same seeded tokens are fed
  to both);
- the reference's own serving test's configuration (reduced Gemma2 on
  ``data=2, model=4`` fake devices, batch 4, max_len 32, prefill and 3
  decode steps) against the port's M = 4 within the same tolerance;
- the collectives: every decode step makes exactly 2 all-reduces a layer
  (attention and FFN, where split), 1 for the embedding and 1 all-gather
  for the logits, and every rank gets the same logits;
- the refusal of a program without a group of M ranks.

The other kinds (MoE, MLA, SSM / hybrid, cross-attention) are in
``test_torch_tp_serve_kinds.py``.

Attention is the plain version of kernel B9 (the tensors lie on the
CPU)."""
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import MeshConfig as JMesh  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.engine import make_serve_program as jprogram  # noqa: E402
from repro_torch.common.config import MeshConfig  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serving.engine import make_serve_program  # noqa: E402

import _torch_dist_helpers as helpers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("tinyllama_1_1b", "gemma2_9b", "granite_20b")
B, S, MAX_LEN, STEPS = 4, 8, 32, 8
KV_START = np.array([0, 3, 9, 14], np.int32)
TOL = dict(rtol=1e-4, atol=1e-5)

# the reference's test_serve_program_decode_on_fake_mesh, its logits kept
FAKE_MESH = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.common.config import MeshConfig
from repro.configs import get_reduced
from repro.launch.mesh import make_worker_mesh
from repro.models import transformer as tr
from repro.serving.engine import make_serve_program

mcfg = MeshConfig(data=2, model=4, pods=1, workers_per_pod=2)
mesh = make_worker_mesh(mcfg)
cfg = get_reduced("gemma2_9b")
prog = make_serve_program(mesh, mcfg, cfg, batch=4, max_len=32, param_dtype=jnp.float32,
                          cache_dtype=jnp.float32, with_prefill=True)
params, _ = tr.init_lm(jax.random.PRNGKey(0), cfg)
rng = np.random.RandomState(7)
prompt = rng.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32)
toks = rng.randint(0, cfg.vocab_size, (3, 4)).astype(np.int32)
last, cache = prog.prefill_fn(params, jnp.asarray(prompt), None)
out = [np.asarray(last)]
for t in range(3):
    logits, cache = prog.decode_fn(params, cache, jnp.asarray(toks[t])[:, None], None)
    out.append(np.asarray(logits))
np.savez(sys.argv[1], prompt=prompt, toks=toks, logits=np.stack(out))
print("FAKE_OK")
"""


def _case(arch):
    """The port's case: the reference's ``init_lm`` weights, a seeded
    prompt and the seeded tokens fed to the decode and decode_slots
    steps."""
    jcfg = jget_reduced(arch)
    rng = np.random.RandomState(ARCHS.index(arch))
    toks = rng.randint(0, jcfg.vocab_size, (1 + 2 * STEPS, B, S)).astype(np.int32)
    return dict(arch=arch, params=jax.tree.map(np.asarray,
                                               jtr.init_lm(jax.random.PRNGKey(0), jcfg)[0]),
                prompt=toks[0], decode=toks[1:1 + STEPS, :, 0], slots=toks[1 + STEPS:, :, 0],
                kv_start=KV_START, max_len=MAX_LEN, models=(2, 4))


def _ref_logits(case):
    """The reference's one-device program on the case: prefill, the decode
    steps, then the decode_slots steps; every step's logits."""
    jcfg = jget_reduced(case["arch"])
    params = jax.tree.map(jnp.asarray, case["params"])
    prog = jprogram(make_host_mesh(), JMesh(data=1, model=1, pods=1, workers_per_pod=1), jcfg,
                    batch=B, max_len=MAX_LEN, param_dtype=jnp.float32,
                    cache_dtype=jnp.float32, with_prefill=True)
    logits, cache = prog.prefill_fn(params, jnp.asarray(case["prompt"]), None)
    out = [np.asarray(logits)]
    for tok in case["decode"]:
        logits, cache = prog.decode_fn(params, cache, jnp.asarray(tok)[:, None], None)
        out.append(np.asarray(logits))
    for tok in case["slots"]:
        logits, cache = prog.decode_slots_fn(params, cache, jnp.asarray(tok)[:, None], None,
                                             jnp.asarray(KV_START))
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's logits per case, the port's results per rank). The
    reference's fake-mesh run goes first in a subprocess, the port's group
    of 4 ranks in a thread meanwhile, the reference's one-device programs in
    this process."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    fake = str(tmp / "fake.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", textwrap.dedent(FAKE_MESH), fake],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    cases = {arch: _case(arch) for arch in ARCHS}
    rng, V = np.random.RandomState(7), get_reduced("gemma2_9b").vocab_size
    prompt = rng.randint(0, V, (4, 8)).astype(np.int32)     # FAKE_MESH's draws
    cases["fake_mesh"] = dict(cases["gemma2_9b"], prompt=prompt,
                              decode=rng.randint(0, V, (3, 4)).astype(np.int32),
                              slots=np.zeros((0, B), np.int32), models=(4,))
    port = []
    mesh = MeshConfig(data=1, model=4, pods=1, workers_per_pod=1)
    worker = threading.Thread(target=lambda: port.extend(tmesh.spawn_model_group(
        helpers.tp_cases, mesh, "cpu", args=(dict(cases=cases),), timeout_s=60,
        join_timeout_s=300, rendezvous_dir=str(tmp))))
    worker.start()
    ref = {arch: _ref_logits(cases[arch]) for arch in ARCHS}
    so, se = sub.communicate(timeout=300)
    worker.join()
    assert sub.returncode == 0 and "FAKE_OK" in so, f"{so}\n{se}"
    with np.load(fake) as z:
        assert np.array_equal(z["prompt"], cases["fake_mesh"]["prompt"])
        assert np.array_equal(z["toks"], cases["fake_mesh"]["decode"])
        ref["fake_mesh"] = z["logits"]
    assert len(port) == 4, "the port's group failed"
    return ref, port


TP_CASES = [(a, M) for a in ARCHS for M in (2, 4)] + [("fake_mesh", 4)]


@pytest.mark.parametrize("case,M", TP_CASES)
def test_tensor_parallel_logits_match_reference(runs, case, M):
    ref, port = runs
    got = port[0][(case, M)]["logits"]
    want = ref[case]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for r in range(1, 4):
        np.testing.assert_array_equal(port[r][(case, M)]["logits"], got)


def _layers(case):
    return get_reduced("gemma2_9b" if case == "fake_mesh" else case).num_layers


@pytest.mark.parametrize("case,M", TP_CASES)
def test_collectives_per_decode_step_are_exact(runs, case, M):
    """2 all-reduces a layer, 1 for the embedding, 1 all-gather; reduced
    Granite-20B's 6 heads stay whole at M = 4 (no attention all-reduce)."""
    ref, port = runs
    rec = port[0][(case, M)]
    L = _layers(case)
    whole_heads = case == "granite_20b" and M == 4
    want = {"all_reduce": L * (1 if whole_heads else 2) + 1, "all_gather": 1}
    assert rec["expected"] == want
    assert rec["steps"] and all({k: s[k] for k in want} == want for s in rec["steps"])
    assert {k: rec["prefill"][k] for k in want} == want


def test_a_program_needs_a_group_of_model_ranks():
    from types import SimpleNamespace
    mesh = MeshConfig(data=1, model=2, pods=1, workers_per_pod=1)
    cfg = get_reduced("tinyllama_1_1b")
    for group in (None, SimpleNamespace(rank=0, world=4)):
        with pytest.raises(ValueError, match="ModelGroup"):
            make_serve_program(cfg, batch=2, max_len=16, device="cpu", mesh_cfg=mesh,
                               group=group)
    with pytest.raises(ValueError, match="model >= 2"):
        tmesh.ModelGroup(0, MeshConfig(data=1, model=1, pods=1, workers_per_pod=1), "cpu")
