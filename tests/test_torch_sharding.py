"""The port's sharding rules (``repro_torch.launch.sharding`` and
``serving.engine.serve_rules``) against the reference's: for every arch,
at its published size (the port's ``abstract_lm`` / ``abstract_cache`` on
the ``meta`` device, the reference's under ``jax.eval_shape``) and reduced,
every leaf's spec equals ``tuple(...)`` of the reference's
``PartitionSpec`` on its device-free worker mesh, for

- the parameters' axes under ``DEFAULT_RULES``;
- the serving KV cache's axes under ``serve_rules``;
- the stacked per-replica parameters (``with_worker_dim``);

over the reference's training-test mesh, its serving-test mesh, the
production mesh with one pod and with two, and a ``model = 3`` mesh that
divides nothing. Pure Python: nothing is allocated."""
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import MeshConfig as JMesh  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jshr  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.common.config import MeshConfig  # noqa: E402
from repro_torch.common.pytree import tree_flatten, tree_unflatten  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import sharding as shr  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

# (data, model, pods, workers_per_pod)
MESHES = {"train_test": (4, 2, 1, 4), "serve_test": (2, 4, 1, 2),
          "production": (16, 16, 1, 4), "multi_pod": (16, 16, 2, 4), "model3": (2, 3, 1, 2)}
SIZES = ("full", "reduced")
BATCH, MAX_LEN = 8, 1024
CASES = [(a, s, m) for a in ARCH_IDS for s in SIZES for m in MESHES]


def _cfgs(arch, size):
    return ((get_config(arch), jget_config(arch)) if size == "full"
            else (get_reduced(arch), jget_reduced(arch)))


@functools.lru_cache(maxsize=None)
def _ref_trees(arch, size):
    jcfg = _cfgs(arch, size)[1]
    return (jtr.abstract_lm(jcfg), jtr.abstract_cache(jcfg, BATCH, MAX_LEN))


@functools.lru_cache(maxsize=None)
def _port_trees(arch, size):
    cfg = _cfgs(arch, size)[0]
    return tr.abstract_lm(cfg), tr.abstract_cache(cfg, BATCH, MAX_LEN)


def _meshes(name):
    data, model, pods, wpp = MESHES[name]
    jm = JMesh(data=data, model=model, pods=pods, workers_per_pod=wpp)
    tm = MeshConfig(data=data, model=model, pods=pods, workers_per_pod=wpp)
    return jm, jmesh.make_abstract_worker_mesh(jm), tm


def _ref_specs(tree):
    leaves = jax.tree.flatten(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [tuple(p) for p in leaves]


def _port_specs(tree):
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            leaves.append(t)
    walk(tree)
    return leaves


def _check(port, ref):
    got, want = _port_specs(port), _ref_specs(ref)
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("arch,size,mesh", CASES)
def test_param_specs_match_reference(arch, size, mesh):
    (jshapes, jaxes), _ = _ref_trees(arch, size)
    (shapes, axes), _ = _port_trees(arch, size)
    _, amesh, tm = _meshes(mesh)
    _check(shr.tree_specs(shapes, axes, tm), jshr.tree_specs(jshapes, jaxes, amesh))


@pytest.mark.parametrize("arch,size,mesh", CASES)
def test_serve_cache_specs_match_reference(arch, size, mesh):
    _, (jshapes, jaxes) = _ref_trees(arch, size)
    _, (shapes, axes) = _port_trees(arch, size)
    _, amesh, tm = _meshes(mesh)
    cfg, jcfg = _cfgs(arch, size)
    # the reference's serve_rules reads the mesh's device array's shape
    sizes = dict(amesh.shape)
    stub = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes,
                                 devices=np.empty(tuple(sizes.values()), np.int8))
    jrules, rules = jengine.serve_rules(jcfg, stub), engine.serve_rules(cfg, tm)
    assert rules == jrules
    _check(shr.tree_specs(shapes, axes, tm, rules),
           jshr.tree_specs(jshapes, jaxes, amesh, jrules))


@pytest.mark.parametrize("arch,size,mesh", CASES)
def test_stacked_param_specs_match_reference(arch, size, mesh):
    (jshapes, jaxes), _ = _ref_trees(arch, size)
    (shapes, axes), _ = _port_trees(arch, size)
    _, amesh, tm = _meshes(mesh)
    W = tm.num_workers
    jstacked = jax.tree.map(lambda s: jax.ShapeDtypeStruct((W,) + s.shape, s.dtype), jshapes)
    leaves, treedef = tree_flatten(shapes)
    stacked = tree_unflatten(treedef, [(W,) + tuple(t.shape) for t in leaves])
    _check(shr.tree_specs(stacked, shr.with_worker_dim(axes), tm),
           jshr.tree_specs(jstacked, jshr.with_worker_dim(jaxes), amesh))
