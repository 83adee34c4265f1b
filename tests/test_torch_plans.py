"""The port's planning data (``common.config`` input shapes,
``launch.plans``, ``launch.specs``) against the reference's.

- the four input shapes, every ``LaunchPlan`` field, ``mesh_config`` on
  one pod and two, and the default train config: equal (exact) for 10
  archs x 4 shapes;
- ``input_specs``: for every arch x shape the same tree, shapes and dtypes
  as the reference's ``ShapeDtypeStruct`` s (``torch.bfloat16`` for
  ``bfloat16``, ``int32`` for ``int32``, exact), every leaf a ``meta``
  tensor (nothing allocated);
- ``DistTrainer.batch_shapes`` / ``state_shapes`` on a reduced config
  against the reference's ``DistTrainer`` (exact);
- refusals: an unknown arch or shape raises ValueError naming it."""
import dataclasses
import functools
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.common import config as jconfig  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import plans as jplans  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import make_abstract_worker_mesh  # noqa: E402
from repro_torch.common import config  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import plans, specs  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_input_shapes_equal_the_reference():
    assert tuple(config.INPUT_SHAPES) == tuple(jconfig.INPUT_SHAPES) == SHAPES
    for name in SHAPES:
        assert _fields(config.INPUT_SHAPES[name]) == _fields(jconfig.INPUT_SHAPES[name])
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert _fields(getattr(config, name)) == _fields(getattr(jconfig, name))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "two_pods"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_and_mesh_equal_the_reference(arch, shape, multi_pod):
    """Every LaunchPlan field and every MeshConfig field (exact)."""
    got, want = plans.make_plan(arch, shape), jplans.make_plan(arch, shape)
    g, w = _fields(got), _fields(want)
    assert _fields(g.pop("shape")) == _fields(w.pop("shape"))
    assert g == w
    gm = plans.mesh_config(got, multi_pod=multi_pod)
    wm = jplans.mesh_config(want, multi_pod=multi_pod)
    assert _fields(gm) == _fields(wm)
    assert (gm.num_chips, gm.num_workers, gm.fsdp) == (wm.num_chips, wm.num_workers, wm.fsdp)


def test_default_train_config_equals_the_reference():
    got, want = specs.default_train_config(), jspecs.default_train_config()
    assert _fields(got.protocol) == _fields(want.protocol)
    assert _fields(got.optimizer) == _fields(want.optimizer)
    assert got.fused_update == want.fused_update and got.codec == want.codec


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts, lists and tuples (None skipped)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {} if tree is None else {"/".join(prefix): tree}


def _state_tree(st):
    """The state's arrays by name (either package's FlatState)."""
    return {"theta": st.theta, "opt_step": st.opt.step, "opt_mu": st.opt.mu,
            "opt_nu": st.opt.nu or None, "center": st.center,
            "residual": st.comm.residual, "step": st.step}


def _port_leaves(tree) -> dict:
    out = {}
    for k, t in _flat(tree).items():
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", (k, t)
        out[k] = (tuple(t.shape), str(t.dtype).split(".")[-1])
    return out


def _ref_leaves(tree) -> dict:
    out = {}
    for k, s in _flat(tree).items():
        assert isinstance(s, jax.ShapeDtypeStruct), (k, s)
        out[k] = (tuple(s.shape), str(np.dtype(s.dtype)))
    return out


def _spec_trees(sp):
    sp = dict(sp)
    if "state" in sp:
        sp["state"] = _state_tree(sp["state"])
    return sp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    """Tree, shapes and dtypes of every input (exact), all four shapes; the
    train shape's state field by field. Each package's ``abstract_lm`` (a
    pure function of the config and dtype, shapes only) is memoised for
    the four shapes of one arch, which cuts the test's time by half."""
    with mock.patch.object(jspecs.tr, "abstract_lm",
                           functools.lru_cache(None)(jspecs.tr.abstract_lm)), \
            mock.patch.object(specs.tr, "abstract_lm",
                              functools.lru_cache(None)(specs.tr.abstract_lm)):
        _input_specs_equal(arch)


def _input_specs_equal(arch):
    for shape in SHAPES:
        got = _port_leaves(_spec_trees(specs.input_specs(arch, shape)))
        want = _ref_leaves(_spec_trees(jspecs.input_specs(arch, shape)))
        assert got == want, (arch, shape, set(got) ^ set(want))


def test_batch_and_state_shapes_equal_the_reference():
    """A reduced TinyLlama and a reduced MusicGen (cond rides the batch) on
    a 4-worker mesh, and with a stateful codec (the residual planes)."""
    mesh_cfg = config.MeshConfig(data=4, model=1, pods=1, workers_per_pod=4)
    jmesh_cfg = jconfig.MeshConfig(data=4, model=1, pods=1, workers_per_pod=4)
    for arch in ("tinyllama_1_1b", "musicgen_large"):
        cfg, jcfg = get_reduced(arch), jget_reduced(arch)
        for codec in ("", "topk"):
            tc = dataclasses.replace(specs.default_train_config(), codec=codec)
            jtc = dataclasses.replace(jspecs.default_train_config(), codec=codec)
            trainer = specs.make_trainer(mesh_cfg, cfg, 2, tc)
            jtrainer = jspecs.make_trainer(make_abstract_worker_mesh(jmesh_cfg), jmesh_cfg,
                                           jcfg, 2, jtc)
            jtrainer.set_shape(16, 32)
            trainer.set_shape(16, 32)
            assert _port_leaves(trainer.batch_shapes()) == _ref_leaves(jtrainer.batch_shapes())
            params = tr.abstract_lm(cfg, specs.PARAM_DTYPE)[0]
            got = _port_leaves(_state_tree(trainer.state_shapes(params)))
            want = _ref_leaves(_state_tree(jtrainer.state_shapes()))
            assert got == want, (arch, codec)


@pytest.mark.parametrize("arch,shape,what", [
    ("no_such_arch", "train_4k", "unknown arch 'no_such_arch'"),
    ("tinyllama_1_1b", "train_8k", "unknown input shape 'train_8k'"),
])
def test_unknown_arch_or_shape_is_refused(arch, shape, what):
    for fn in (plans.make_plan, specs.input_specs, specs.build_programs):
        with pytest.raises(ValueError, match=what):
            fn(arch, shape)
