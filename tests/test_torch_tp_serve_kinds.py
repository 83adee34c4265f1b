"""Tensor-parallel serving of the MoE, MLA, SSM / hybrid and
cross-attention models (``make_serve_program(mesh_cfg=..., group=...)``
with ``model = M > 1``) against the reference's serving programs.

The port serves over gloo groups on the CPU: one group of 4 ranks and its
two halves as groups of 2, in f32, on the reference's ``init_lm`` weights
(every cross gate opened to 0.5, a seeded random ``cond``). Checked, at M
= 2 and 4, for reduced DeepSeek-V2-Lite (MLA, MoE with a shared expert, a
dense first layer), Grok-1 (MoE, GQA; at M = 4 the kv heads whole), xLSTM
(mLSTM + sLSTM, the sLSTM whole on every rank; its 2 heads whole at M = 4,
so also a 4-head variant that splits there), Grok-1 with 6 experts (split
by ffn at M = 4), Zamba2 (Mamba2 + shared attention blocks), MusicGen (two
codebooks, ``attn_cross`` layers) and Llama-3.2-Vision (``cross_blk``):

- prefill, 8 decode steps and 8 ``decode_slots`` steps with a
  ``kv_start``: every step's logits within rtol 1e-4 / atol 1e-5 of the
  reference's ``make_serve_program`` on a one-device host mesh (the
  recurrent models within the rtol 1e-4 / atol 1e-4 that
  ``test_torch_ssm.py`` holds the port's one-device program to: that
  program is itself up to ~3e-5 from the reference's there, the chunked
  products summed in other orders) and within 1e-5 of the largest logit of
  the port's one-device program (the chip's gate), every greedy token
  (argmax) equal, every rank's logits equal;
- reduced DeepSeek and Zamba2 at M = 2 against the reference's own program
  on a ``model = 2`` fake host mesh (8 fake devices in a subprocess), which
  splits the MLA latent cache by sequence, the experts and the Mamba2
  state by ``inner``;
- the collectives of the prefill and of every decode step exact, and
  equal to a count written out here by hand;
- the MoE routing ids of every layer and call bit-equal to the reference's
  ``_route`` on every rank;
- ``init_params`` (each leaf sliced as drawn) bit-equal to ``place_params``
  of the whole tree, and a layout that cannot split raises.

Attention is the plain version of kernel B9 (the tensors lie on the
CPU)."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import MeshConfig as JMesh  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.engine import make_serve_program as jprogram  # noqa: E402
from repro_torch.common.config import MeshConfig  # noqa: E402
from repro_torch.common.pytree import tree_flatten  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving import tensor_parallel as tp  # noqa: E402
from repro_torch.serving.engine import make_serve_program  # noqa: E402

import _torch_dist_helpers as helpers  # noqa: E402
from _torch_cross_cases import open_gates  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("deepseek_v2_lite_16b", "grok_1_314b", "xlstm_125m", "zamba2_2_7b",
         "musicgen_large", "llama_3_2_vision_11b")
# variants of the reduced configs: xLSTM with heads that split at M = 4,
# Grok-1 with 6 experts, which M = 4 does not divide (its experts then split
# by ffn, as the spec falls to that dim)
VARIANTS = {"xlstm_125m/4 heads": dict(num_heads=4, num_kv_heads=4),
            "grok_1_314b/6 experts": dict(moe=dict(num_experts=6))}
B, S, MAX_LEN, STEPS = 4, 8, 32, 8
KV_START = np.array([0, 3, 9, 14], np.int32)
TOL = dict(rtol=1e-4, atol=1e-5)
RECURRENT_TOL = dict(rtol=1e-4, atol=1e-4)      # test_torch_ssm.py's MODEL_TOL
GATE_REL = 1e-5                # largest |logit diff| / largest |logit| (chip_smoke.py's gate)
FAKE = ("deepseek_v2_lite_16b", "zamba2_2_7b")
FAKE_STEPS = 4

# the reference's own serving program on a model = 2 fake host mesh
FAKE_MESH = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.common.config import MeshConfig
from repro.configs import get_reduced
from repro.launch.mesh import make_worker_mesh
from repro.models import transformer as tr
from repro.serving.engine import make_serve_program

mcfg = MeshConfig(data=1, model=2, pods=1, workers_per_pod=1)
mesh = make_worker_mesh(mcfg)
out = {}
for i, arch in enumerate(sys.argv[2].split(",")):
    cfg = get_reduced(arch)
    prog = make_serve_program(mesh, mcfg, cfg, batch=4, max_len=32, param_dtype=jnp.float32,
                              cache_dtype=jnp.float32, with_prefill=True)
    params, _ = tr.init_lm(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(100 + i)
    prompt = rng.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    toks = rng.randint(0, cfg.vocab_size, (%d, 4)).astype(np.int32)
    last, cache = prog.prefill_fn(params, jnp.asarray(prompt), None)
    logits = [np.asarray(last)]
    for t in toks:
        last, cache = prog.decode_fn(params, cache, jnp.asarray(t)[:, None], None)
        logits.append(np.asarray(last))
    out[arch + "/prompt"], out[arch + "/toks"] = prompt, toks
    out[arch + "/logits"] = np.stack(logits)
np.savez(sys.argv[1], **out)
print("FAKE_OK")
""" % FAKE_STEPS


def _jcfg(name):
    return helpers.replaced(jget_reduced(name.split("/")[0]), VARIANTS.get(name, {}))


def _case(name, seed):
    """The port's case: the reference's ``init_lm`` weights (gates open), a
    seeded prompt, the seeded tokens fed to the decode and decode_slots
    steps, a seeded ``cond`` for the cross models."""
    arch = name.split("/")[0]
    jcfg = _jcfg(name)
    rng = np.random.RandomState(seed)
    K = () if jcfg.audio is None else (jcfg.audio.num_codebooks,)
    toks = rng.randint(0, jcfg.vocab_size, (1 + 2 * STEPS, B) + K + (S,)).astype(np.int32)
    case = dict(arch=arch, params=open_gates(jax.tree.map(
                    np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg)[0])),
                prompt=toks[0], decode=toks[1:1 + STEPS, ..., 0],
                slots=toks[1 + STEPS:, ..., 0], kv_start=KV_START, max_len=MAX_LEN,
                models=(2, 4), routes=jcfg.moe is not None)
    if name in VARIANTS:
        case["replace"] = VARIANTS[name]
    if jcfg.audio is not None:
        case["cond"] = rng.randn(B, jcfg.audio.num_cond_tokens, jcfg.d_model).astype(np.float32)
    elif jcfg.vlm is not None:
        case["cond"] = rng.randn(B, jcfg.vlm.num_image_tokens,
                                 jcfg.vlm.image_embed_dim).astype(np.float32)
    return case


def _ref_run(name, case):
    """The reference's one-device program on the case: prefill, the decode
    steps, then the decode_slots steps; every step's logits and, for MoE,
    every ``_route`` call's ids in call order."""
    jcfg = _jcfg(name)
    params = jax.tree.map(jnp.asarray, case["params"])
    cond = case.get("cond")
    cond = None if cond is None else jnp.asarray(cond)
    routes = []
    real = jmoe._route

    def spy(logits, top_k):
        out = real(logits, top_k)
        jax.debug.callback(lambda ids: routes.append(np.asarray(ids)), out[2], ordered=True)
        return out

    with mock.patch.object(jmoe, "_route", spy):
        prog = jprogram(make_host_mesh(), JMesh(data=1, model=1, pods=1, workers_per_pod=1),
                        jcfg, batch=B, max_len=MAX_LEN, param_dtype=jnp.float32,
                        cache_dtype=jnp.float32, with_prefill=True)
        logits, cache = prog.prefill_fn(params, jnp.asarray(case["prompt"]), cond)
        out = [np.asarray(logits)]
        for tok in case["decode"]:
            logits, cache = prog.decode_fn(params, cache, jnp.asarray(tok)[..., None], cond)
            out.append(np.asarray(logits))
        for tok in case["slots"]:
            logits, cache = prog.decode_slots_fn(params, cache, jnp.asarray(tok)[..., None],
                                                 cond, jnp.asarray(KV_START))
            out.append(np.asarray(logits))
        jax.effects_barrier()
    return np.stack(out), routes


def _port_one(name, case):
    """The port's one-device program on the case: every step's logits."""
    cfg = helpers.replaced(get_reduced(case["arch"]), case.get("replace", {}))
    params = tr.params_from_jax(case["params"], "cpu", torch.float32)
    cond = case.get("cond")
    cond = None if cond is None else torch.from_numpy(cond)
    prog = make_serve_program(cfg, batch=B, max_len=MAX_LEN, param_dtype=torch.float32,
                              cache_dtype=torch.float32, with_prefill=True, device="cpu")
    logits, cache = prog.prefill_fn(params, torch.from_numpy(case["prompt"]), cond)
    out = [logits.numpy()]
    for t, tok in enumerate(list(case["decode"]) + list(case["slots"])):
        tok = torch.from_numpy(np.ascontiguousarray(tok))[..., None]
        if t < len(case["decode"]):
            logits, cache = prog.decode_fn(params, cache, tok, cond)
        else:
            logits, cache = prog.decode_slots_fn(params, cache, tok, cond,
                                                 torch.from_numpy(KV_START))
        out.append(logits.numpy())
    return np.stack(out)


NAMES = ARCHS + tuple(VARIANTS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's logits and routes per case, the port's results per
    rank). The reference's fake-mesh run goes first in a subprocess, the
    port's group of 4 ranks in a thread meanwhile, the reference's
    one-device programs in this process."""
    tmp = tmp_path_factory.mktemp("tp_kinds")
    fake = str(tmp / "fake.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", textwrap.dedent(FAKE_MESH), fake,
                            ",".join(FAKE)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    cases = {name: _case(name, 20 + i) for i, name in enumerate(NAMES)}
    for i, arch in enumerate(FAKE):      # FAKE_MESH's draws
        rng, V = np.random.RandomState(100 + i), get_reduced(arch).vocab_size
        prompt = rng.randint(0, V, (B, S)).astype(np.int32)
        cases[f"fake/{arch}"] = dict(cases[arch], prompt=prompt,
                                     decode=rng.randint(0, V, (FAKE_STEPS, B)).astype(np.int32),
                                     slots=np.zeros((0, B), np.int32), models=(2,),
                                     routes=False)
    port = []
    mesh = MeshConfig(data=1, model=4, pods=1, workers_per_pod=1)
    worker = threading.Thread(target=lambda: port.extend(tmesh.spawn_model_group(
        helpers.tp_cases, mesh, "cpu", args=(dict(cases=cases),), timeout_s=120,
        join_timeout_s=600, rendezvous_dir=str(tmp))))
    worker.start()
    ref = {name: _ref_run(name, cases[name]) for name in NAMES}
    one = {name: _port_one(name, cases[name]) for name in cases}
    so, se = sub.communicate(timeout=600)
    worker.join()
    assert sub.returncode == 0 and "FAKE_OK" in so, f"{so}\n{se}"
    with np.load(fake) as z:
        for arch in FAKE:
            assert np.array_equal(z[arch + "/prompt"], cases[f"fake/{arch}"]["prompt"])
            assert np.array_equal(z[arch + "/toks"], cases[f"fake/{arch}"]["decode"])
            ref[f"fake/{arch}"] = (z[arch + "/logits"], None)
    assert len(port) == 4, "the port's group failed"
    return ref, port, one


TP_CASES = [(n, M) for n in NAMES for M in (2, 4)] + [(f"fake/{a}", 2) for a in FAKE]


def _recurrent(case):
    return get_reduced(case.split("/")[-1] if case.startswith("fake/")
                       else case.split("/")[0]).arch_type in ("ssm", "hybrid")


@pytest.mark.parametrize("case,M", TP_CASES)
def test_tensor_parallel_logits_match_reference(runs, case, M):
    ref, port, one = runs
    got = port[0][(case, M)]["logits"]
    want = ref[case][0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(RECURRENT_TOL if _recurrent(case) else TOL))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the split against the port's one-device program: the chip's gate
    assert np.abs(got - one[case]).max() <= GATE_REL * np.abs(one[case]).max()
    for r in range(1, 4):
        np.testing.assert_array_equal(port[r][(case, M)]["logits"], got)


def _by_hand(case, M):
    """(all-reduces, all-gathers) of a decode step, counted from each
    model's layers: attention and the FFN or MoE layer once each where
    split, MusicGen's cross-attention once more, a Mamba2 or mLSTM mixer
    twice (its norm's sum of squares and its output), an sLSTM mixer none
    (it runs whole), the embedding once and the logits' gather."""
    arch = case.split("/")[-1] if case.startswith("fake/") else case.split("/")[0]
    four = case == "xlstm_125m/4 heads"
    return {
        "deepseek_v2_lite_16b": (2 * 2 + 1, 1),   # 1 dense + 1 MoE layer
        "grok_1_314b": (2 * 2 + 1, 1),
        # 1 mLSTM + 1 sLSTM layer; the 2 heads run whole at M = 4
        "xlstm_125m": (2 + 1, 1) if (M == 2 or four) else (1, 1),
        "zamba2_2_7b": (2 * 2 + 2 + 1, 1),        # 2 Mamba2 layers, 1 shared site
        "musicgen_large": (3 * 2 + 1, 1),
        "llama_3_2_vision_11b": (2 * 2 + 2 + 1, 1),   # 2 layers, 1 cross block
    }[arch]


@pytest.mark.parametrize("case,M", TP_CASES)
def test_collectives_per_step_are_exact(runs, case, M):
    ref, port, _ = runs
    for r in range(4):
        rec = port[r][(case, M)]
        ar, ag = _by_hand(case, M)
        want = {"all_reduce": ar, "all_gather": ag}
        assert rec["expected"] == want
        assert rec["steps"] and all({k: s[k] for k in want} == want for s in rec["steps"])
        # a prefill makes the same
        assert {k: rec["prefill"][k] for k in want} == want


MOE_CASES = [(a, M) for a in NAMES if _jcfg(a).moe is not None for M in (2, 4)]


@pytest.mark.parametrize("case,M", MOE_CASES)
def test_moe_routing_ids_bit_equal_to_reference(runs, case, M):
    ref, port, _ = runs
    want = ref[case][1]
    calls = 1 + 2 * STEPS
    cfg = helpers.replaced(get_reduced(case.split("/")[0]), VARIANTS.get(case, {}))
    layers = sum(s.count for s in tr.make_plan(cfg).segments if s.use_moe)
    assert len(want) == calls * layers
    for r in range(4):
        got = port[r][(case, M)]["routes"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _leaves(tree):
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("arch,M", [(a, M) for a in ARCHS for M in (2, 4)])
def test_init_params_keeps_the_slice_as_drawn(arch, M):
    """``init_params`` draws every leaf and keeps the rank's slice: the same
    bytes as slicing the whole tree, on each rank."""
    cfg = get_reduced(arch)
    mesh = MeshConfig(data=1, model=M, pods=1, workers_per_pod=1)
    for rank in (0, M - 1):
        prog = make_serve_program(cfg, batch=2, max_len=16, param_dtype=torch.float32,
                                  cache_dtype=torch.float32, device="cpu", mesh_cfg=mesh,
                                  group=SimpleNamespace(rank=rank, world=M))
        whole = prog.place_params(tr.init_lm(torch.Generator().manual_seed(3), cfg)[0])
        drawn = prog.init_params(torch.Generator().manual_seed(3))
        a, b = _leaves(whole), _leaves(drawn)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y)
        # the slices of the M ranks make up the whole tree's bytes
        if rank == 0:
            full = sum(t.numel() for t in _leaves(tr.init_lm(torch.Generator(), cfg)[0]))
            assert sum(t.numel() for t in a) < full


def test_layouts_that_cannot_split_raise_naming_the_shapes():
    mesh = MeshConfig(data=1, model=4, pods=1, workers_per_pod=1)
    # 12 heads of 3 kv heads (whole: 3 does not divide 4) over 4 ranks: a
    # rank's 3 q heads span 2 kv groups of 4
    cfg = dataclasses.replace(get_reduced("grok_1_314b"), num_heads=12, num_kv_heads=3)
    with pytest.raises(ValueError, match="12 heads of 3 kv heads over model=4"):
        tp.make_layout(cfg, mesh, 1)
    cfg = get_reduced("zamba2_2_7b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, ngroups=2))
    with pytest.raises(ValueError, match="16 heads in 2 groups over model=4: the split keeps "
                                         "one group"):
        tp.make_layout(cfg, mesh, 0)


def test_full_width_layouts_split_every_kind():
    """At the published widths every kind of the six archs splits over 2 and
    4 ranks (nothing runs whole), and DeepSeek's expert and MLA leaves get
    the rank's part."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for M in (2, 4):
            lay = tp.make_layout(cfg, MeshConfig(data=1, model=M, pods=1, workers_per_pod=1), 0)
            assert lay.heads and lay.vocab
            assert lay.mixer == (cfg.arch_type in ("ssm", "hybrid"))
            assert lay.experts == (cfg.moe is not None)
    cfg = get_config("deepseek_v2_lite_16b")
    lay = tp.make_layout(cfg, MeshConfig(data=1, model=2, pods=1, workers_per_pod=1), 1)
    shapes = tr.abstract_lm(cfg)[0]["segments"]["seg1_attn_moe"]
    got = {k: tuple(tp.slice_leaf(cfg, lay, ("segments", "seg1_attn_moe") + k, t).shape)
           for k, t in ((("ffn", "w_up"), shapes["ffn"]["w_up"]),
                        (("ffn", "router"), shapes["ffn"]["router"]),
                        (("attn", "k_up"), shapes["attn"]["k_up"]),
                        (("attn", "kv_down"), shapes["attn"]["kv_down"]))}
    assert got == {("ffn", "w_up"): (26, 32, 2048, 1408), ("ffn", "router"): (26, 2048, 64),
                   ("attn", "k_up"): (26, 512, 8, 128), ("attn", "kv_down"): (26, 2048, 576)}
