"""Port layout parity: the torch FlatSpec gives the reference's offsets and
totals, and the same params flatten to equal buffers; plus the isolation
guard that keeps jax and the reference package out of ``repro_torch``."""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread each keeps torch from oversubscribing them (the tensors are small)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common import flat as jflat  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.common import flat as tflat  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _mixed_shapes(_key):
    return {
        "enc": {"w": jax.ShapeDtypeStruct((7, 33), jnp.bfloat16),
                "b": jax.ShapeDtypeStruct((33,), jnp.float32)},
        "a": jax.ShapeDtypeStruct((130,), jnp.float32),
        "scale": jax.ShapeDtypeStruct((), jnp.float32),
        "head": jax.ShapeDtypeStruct((33, 5), jnp.bfloat16),
    }


# shapes from the reference initializers; values from numpy (the reference's
# eager jax.random init of the CNN alone takes ~15 s on the CPU)
SHAPES = {
    "mlp_full": lambda k: jsimple.init_mlp(k)[0],
    "mlp_small": lambda k: jsimple.init_mlp(k, 784, 64, 2, 10)[0],
    "cnn": lambda k: jsimple.init_cnn(k, width=8)[0],
    "mixed": _mixed_shapes,
}


def _tree(name, lead=()):
    shapes = jax.eval_shape(SHAPES[name], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda s: jnp.asarray(np.asarray(rng.randn(*(lead + s.shape)), np.float32), s.dtype),
        shapes)


def _mixed_tree():
    return _tree("mixed")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same_layout(js, ts):
    assert ts.totals == js.totals
    assert len(ts.slots) == len(js.slots)
    for a, b in zip(js.slots, ts.slots):
        assert (a.bucket, a.offset, a.size, a.shape) == (b.bucket, b.offset, b.size, b.shape)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_layout_and_buffers_match_reference(name):
    jtree = _tree(name)
    js = jflat.FlatSpec.build(jtree)
    ttree = tsimple.params_from_jax(_np_tree(jtree), "cpu")
    ts = tflat.FlatSpec.build(ttree)
    _assert_same_layout(js, ts)
    # exact: flattening is pure data movement
    jb, tb = js.flatten(jtree), ts.flatten(ttree)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k], np.float32),
                                      tb[k].float().numpy())


def test_full_width_mlp_plane_is_the_documented_one():
    """§4.1 MLP 784 -> 3x1024 -> 10: one f32 bucket of 2,913,408 elements,
    leaves b0, b1, b2, b_out, w0, w1, w2, w_out (sorted keys)."""
    gen = torch.Generator().manual_seed(0)
    ts = tflat.FlatSpec.build(tsimple.init_mlp(gen)[0])
    assert ts.totals == {"float32": 2913408}
    assert [s.offset for s in ts.slots] == [0, 1024, 2048, 3072, 3200, 806016,
                                             1854592, 2903168]


def test_port_init_mlp_layout_matches_reference():
    """init_mlp inserts w0 before b0; the port must still sort the keys."""
    gen = torch.Generator().manual_seed(0)
    tparams, taxes = tsimple.init_mlp(gen, 784, 64, 2, 10)
    jparams, jaxes = jsimple.init_mlp(jax.random.PRNGKey(0), 784, 64, 2, 10)
    _assert_same_layout(jflat.FlatSpec.build(jparams), tflat.FlatSpec.build(tparams))
    assert taxes == jaxes
    # Kaiming std sqrt(2 / fan_in), zero biases
    w0 = tparams["w0"]
    np.testing.assert_allclose(float(w0.std()), np.sqrt(2.0 / 784), rtol=0.05)
    assert float(tparams["b0"].abs().sum()) == 0.0


def test_stacked_roundtrip_views_and_lead():
    W = 3
    jstack = _tree("mixed", lead=(W,))
    tstack = tsimple.params_from_jax(_np_tree(jstack), "cpu")
    js = jflat.FlatSpec.build(jstack, leading=1)
    ts = tflat.FlatSpec.build(tstack, leading=1)
    _assert_same_layout(js, ts)
    bufs = ts.flatten(tstack)
    for k, b in bufs.items():
        assert tuple(b.shape) == (W, ts.totals[k])
        # flatten never aliases its argument
        assert all(b.data_ptr() != x.data_ptr() for x in tree_leaves(tstack))
    back = ts.unflatten(bufs)
    for a, b in zip(jax.tree.leaves(_np_tree(jstack)), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    # a row's views alias the buffers (no copy) and carry the buckets' dtypes
    row = ts.with_lead(()).views({k: v[1] for k, v in bufs.items()})
    assert row["enc"]["w"].dtype == torch.bfloat16
    slot_a = ts.slots[0]                      # sorted keys: "a" comes first
    assert slot_a.bucket == "float32" and slot_a.shape == (130,)
    assert row["a"].data_ptr() == bufs["float32"][1].data_ptr() + slot_a.offset * 4


def test_views_gradient_lands_on_the_flat_plane():
    """Gradients through views arrive flat with zeros in the lane padding."""
    gen = torch.Generator().manual_seed(1)
    params = tsimple.init_mlp(gen, 20, 8, 1, 3)[0]
    spec = tflat.FlatSpec.build(params)
    buf = spec.flatten(params)["float32"].requires_grad_(True)
    loss = sum((v.float() ** 2).sum() for v in tree_leaves(spec.views({"float32": buf})))
    loss.backward()
    np.testing.assert_allclose(buf.grad.numpy(), 2 * buf.detach().numpy(), rtol=1e-6)
    for s in spec.slots:
        pad = buf.grad[s.offset + s.size:tflat._align(s.offset + s.size)]
        assert float(pad.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# isolation: the port never loads jax or the reference package
# ---------------------------------------------------------------------------

def test_import_repro_torch_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert {'repro_torch.comm.codecs', 'repro_torch.comm.registry',\n"
        "        'repro_torch.kernels.codec', 'repro_torch.core.gossip_dist',\n"
        "        'repro_torch.core.scheduler', 'repro_torch.core.consensus',\n"
        "        'repro_torch.train.step', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.dist_run', 'repro_torch.kernels.flash_attention',\n"
        "        'repro_torch.models.transformer', 'repro_torch.serving.engine',\n"
        "        'repro_torch.serve.traffic', 'repro_torch.obs.metrics',\n"
        "        'repro_torch.configs.gemma2_9b',\n"
        "        'repro_torch.launch.serve_decode', 'repro_torch.checkpoint.io',\n"
        "        'repro_torch.launch.paper_tables', 'repro_torch.models.simple',\n"
        "        'repro_torch.common.precision', 'repro_torch.shard.layout',\n"
        "        'repro_torch.obs.observer', 'repro_torch.obs.trace',\n"
        "        'repro_torch.obs.report', 'repro_torch.obs.schema'} <= set(sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
                       r"from\s+repro(\.|\s))", re.M)


def test_port_sources_name_neither_jax_nor_repro():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    hits = []
    for path in files:
        with open(path) as fh:
            for m in FORBIDDEN.finditer(fh.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits
