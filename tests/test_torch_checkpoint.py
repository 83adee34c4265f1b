"""Checkpoint v2 files between the two packages, and resumes within the
port.

A file written by either package loads in the other bit for bit on f32
planes (sim with NAG, adamw and top-k); the payload's entries, dtypes,
shapes and metadata are the reference's; a v1 per-leaf file written by the
reference's ``io.save`` loads bit-exactly; a bf16 plane is written as the
reference's bytes and read back through its bits; the restore refusals
raise; a port resume continues the uninterrupted run bit for bit, gates and
peers included; and a 2-rank dist resume over gloo does so on every rank.
The reference cannot restore its own bf16 files (ROADMAP "Caveats about the
reference"), so the cross-package cases use f32 planes."""
import collections
import functools
import os
import zipfile

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.common.config import OptimizerConfig as JOpt  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.api.state import generator_from_key  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.common.config import MeshConfig as TMesh  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.core import protocols as tprotocols  # noqa: E402
from repro_torch.launch import dist_run  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

IN, HID, DEPTH, NCLS, W, B, STEPS = 784, 32, 2, 10, 4, 8, 3
PROTO = dict(method="elastic_gossip", comm_probability=0.5, moving_rate=0.5,
             topology="uniform")
# case -> (optimizer kwargs, codec)
CASES = {"nag": (dict(name="nag", learning_rate=1e-2, momentum=0.9), "none"),
         "adamw": (dict(name="adamw", learning_rate=1e-3, weight_decay=0.01), "none"),
         "topk": (dict(name="nag", learning_rate=1e-2, momentum=0.9), "topk")}


@functools.lru_cache(maxsize=None)
def _data():
    train, _ = jsyn.load_mnist(data_dir="", num_train=512, num_test=64)
    shards = jpart.partition_iid(train, W, 0)
    return [jpart.batches_for_step(shards, i, B) for i in range(2 * STEPS)]


@functools.lru_cache(maxsize=None)
def _jparams():
    return jsimple.init_mlp(jax.random.PRNGKey(0), IN, HID, DEPTH, NCLS)[0]


def _tparams():
    return tsimple.params_from_jax(jax.tree.map(np.asarray, _jparams()), "cpu")


def _jloss(p, x, y):
    return jsimple.xent_loss(jsimple.mlp_logits(p, x), y)


def _tloss(p, x, y):
    return tsimple.xent_loss(tsimple.mlp_logits(p, x), y)


def _trainers(case):
    opt, codec = CASES[case]
    jtr = JTrainer(engine="sim", protocol=JProto(codec=codec, **PROTO), optimizer=JOpt(**opt),
                   loss_fn=_jloss, num_workers=W)
    ttr = TTrainer(engine="sim", protocol=TProto(codec=codec, **PROTO), optimizer=TOpt(**opt),
                   loss_fn=_tloss, num_workers=W, device="cpu")
    return jtr, ttr


def _ref_run(case, steps=STEPS):
    """The reference's state after ``steps`` steps, and the draws it made."""
    jtr, _ = _trainers(case)
    st = jtr.init_state(0, params=_jparams())
    draws = []
    for x, y in _data()[:steps]:
        gate, peers = jtr._backend.sim._draw_fn(jnp.array(st.key), jnp.array(st.step))
        draws.append((np.array(gate), np.array(peers)))
        st, _ = jtr.step(st, (jnp.asarray(x), jnp.asarray(y)))
    return jtr, st, draws


def _port_run(case, draws):
    _, ttr = _trainers(case)
    st = ttr.init_state(0, params=_tparams())
    for (x, y), (gate, peers) in zip(_data(), draws):
        st, _ = ttr.step(st, (torch.from_numpy(x), torch.from_numpy(y)),
                         draws=(torch.from_numpy(gate), torch.from_numpy(peers)))
    return ttr, st


def _jentries(state):
    """The reference state's checkpoint entries (its own flattening)."""
    return {k: np.asarray(v) for k, v in jio._flatten(state.state_dict()).items()}


def _assert_bit_equal(a, b, keys):
    for k in keys:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (k, a[k].dtype, b[k].dtype)
        assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# the file between the packages, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_file_loads_into_the_port_bit_for_bit(case, tmp_path):
    jtr, jst, _ = _ref_run(case)
    path = str(tmp_path / "ref.npz")
    jtr.save_checkpoint(path, jst, meta={"step": STEPS})
    want = _jentries(jst)
    _, ttr = _trainers(case)
    got_state, meta = ttr.load_checkpoint(path, ttr.init_state(1, params=_tparams()))
    assert meta["step"] == STEPS and meta["format"] == tio.FLAT_FORMAT
    got = tio.entries(got_state.state_dict())
    _assert_bit_equal(got, want, sorted(set(want) - {"key"}))
    # the reference's threefry key cannot seed the port's generator as it
    # is: the port reseeds from it and the step, deterministically
    again, _ = ttr.load_checkpoint(path, ttr.init_state(2, params=_tparams()))
    assert torch.equal(got_state.key.get_state(), again.key.get_state())
    assert got_state.theta["float32"].device.type == "cpu"


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_file_loads_into_the_reference_bit_for_bit(case, tmp_path):
    jtr, _, draws = _ref_run(case)
    ttr, tst = _port_run(case, draws)
    path = str(tmp_path / "port.npz")
    ttr.save_checkpoint(path, tst, meta={"step": STEPS})
    want = tio.entries(tst.state_dict())
    jst, meta = jtr.load_checkpoint(path, jtr.init_state(1, params=_jparams()))
    got = _jentries(jst)
    assert set(want) - set(got) == {"torch_key::cpu"}
    _assert_bit_equal(got, want, sorted(got))
    # key: what jax.random.PRNGKey(seed) gives for the port's seed 0
    np.testing.assert_array_equal(got["key"], np.asarray(jax.random.PRNGKey(0)))
    assert meta["protocol"]["method"] == "elastic_gossip"


def _cnn_files(tmp_path, case):
    opt, codec = CASES[case]
    jp = jsimple.init_cnn(jax.random.PRNGKey(0), width=8)[0]
    tp = tsimple.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")

    def jl(p, x, y):
        return jsimple.xent_loss(jsimple.cnn_logits(p, x), y)

    def tl(p, x, y):
        return tsimple.xent_loss(tsimple.cnn_logits(p, x), y)

    jtr = JTrainer(engine="sim", protocol=JProto(codec=codec, **PROTO), optimizer=JOpt(**opt),
                   loss_fn=jl, num_workers=W)
    ttr = TTrainer(engine="sim", protocol=TProto(codec=codec, **PROTO), optimizer=TOpt(**opt),
                   loss_fn=tl, num_workers=W, device="cpu")
    paths = (str(tmp_path / "ref.npz"), str(tmp_path / "port.npz"))
    jtr.save_checkpoint(paths[0], jtr.init_state(0, params=jp))
    ttr.save_checkpoint(paths[1], ttr.init_state(0, params=tp))
    return paths


@pytest.mark.parametrize("case", sorted(CASES))
def test_payload_entries_and_metadata_are_the_reference_s(case, tmp_path):
    """The CNN on the sim engine: the entries of the Motivation's list, the
    same numpy dtypes and shapes, and the same metadata."""
    ref, port = _cnn_files(tmp_path, case)
    rp, pp = jio.load_payload(ref), tio.load_payload(port)
    want = {"theta::float32", "opt::mu::float32", "opt::step", "step",
            "proto::comm_rounds", "proto::comm_units", "proto::comm_bytes", "key"}
    want |= {"adamw": {"opt::nu::float32"}, "topk": {"comm::residual::float32"}}.get(case, set())
    assert set(rp) == want
    assert set(pp) == want | {"torch_key::cpu"}
    total = rp["theta::float32"].shape[1]
    for k in want:
        assert (pp[k].dtype.str, pp[k].shape) == (rp[k].dtype.str, rp[k].shape), k
    assert rp["theta::float32"].shape == (W, total) and total % 128 == 0
    assert rp["key"].dtype == np.uint32 and rp["key"].shape == (2,)
    for k in ("opt::step", "step", "proto::comm_rounds", "proto::comm_units"):
        assert rp[k].dtype == np.int32 and rp[k].shape == ()
    assert rp["proto::comm_bytes"].dtype == np.float32
    jm, tm = jio.load_meta(ref), tio.load_meta(port)
    assert set(jm) == set(tm) == {"protocol", "format", "flat_spec"}
    assert jm["format"] == tm["format"] == 2
    assert jm["flat_spec"] == tm["flat_spec"]


def test_v1_per_leaf_file_loads_bit_exactly(tmp_path):
    """A pre-FlatState file (the SimState era's per-leaf layout inside
    NamedTuple containers), written by the reference's ``io.save``, as in
    tests/test_flat_state.py."""
    jtr, jst, _ = _ref_run("topk")
    OptT = collections.namedtuple("OptState", "step mu nu")
    ProtoT = collections.namedtuple("ProtocolState", "center comm_rounds comm_units comm_bytes")
    CommT = collections.namedtuple("CommState", "residual")
    legacy = {
        "params": jst.params,
        "opt": OptT(jst.opt.step, jst.velocity, {}),
        "proto": ProtoT(None, jst.proto.comm_rounds, jst.proto.comm_units,
                        jst.proto.comm_bytes),
        "key": jst.key, "step": jst.step,
        "comm": CommT(jax.tree.map(lambda v: v.astype(jnp.float32),
                                   jst.spec.unflatten(jst.comm.residual))),
    }
    want = _jentries(jst)
    v1 = str(tmp_path / "v1.npz")
    jio.save(v1, legacy, meta={"step": STEPS})
    assert "params::w0" in jio.load_payload(v1)
    _, ttr = _trainers("topk")
    got_state, _ = ttr.load_checkpoint(v1, ttr.init_state(1, params=_tparams()))
    _assert_bit_equal(tio.entries(got_state.state_dict()), want, sorted(set(want) - {"key"}))
    # the port's own v1 form: save() flattens NamedTuple fields as '.field'
    tv1 = str(tmp_path / "tv1.npz")
    tio.save(tv1, {"opt": OptT(torch.zeros((), dtype=torch.int32), {"w": torch.ones(3)}, {})})
    assert set(tio.load_payload(tv1)) == {"opt::.step", "opt::.mu::w"}


def test_bf16_plane_is_the_reference_s_bytes_and_round_trips(tmp_path):
    """A bf16 bucket is written as the reference writes it (raw bits under
    '<V2'), byte for byte, read back through its bits in both directions,
    and a facade round trip with a bf16 bucket is bit-exact."""
    bits = np.array([0x3FC0, 0xC000, 0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0x0001,
                     0x3F81, 0x4049], dtype=np.uint16)
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    j = jnp.asarray(bits).view(jnp.bfloat16)
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tio.save(tp, {"theta": {"bfloat16": t}})
    jio.save(jp, {"theta": {"bfloat16": j}})
    member = "theta::bfloat16.npy"
    with zipfile.ZipFile(tp) as zt, zipfile.ZipFile(jp) as zj:
        assert zt.namelist() == zj.namelist() == [member]
        assert zt.read(member) == zj.read(member)
    assert float(t[0]) == 1.5 and bits[0] == 16320
    for path in (tp, jp):
        got = tio.to_tensor(tio.load_payload(path)["theta::bfloat16"], "cpu")
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), bits)

    # a plane with an f32 and a bf16 bucket through the facade (fused path:
    # the storage dtypes stay)
    def loss(p, x, y):
        return _tloss({k: v.float() for k, v in p.items()}, x, y)

    params = {k: (v.to(torch.bfloat16) if k.startswith("w") else v)
              for k, v in _tparams().items()}
    ttr = TTrainer(engine="sim", protocol=TProto(**PROTO), optimizer=TOpt(**CASES["nag"][0]),
                   loss_fn=loss, num_workers=W, device="cpu")
    st = ttr.init_state(0, params=params)
    for x, y in _data()[:2]:
        st, _ = ttr.step(st, (torch.from_numpy(x), torch.from_numpy(y)))
    path = str(tmp_path / "mixed.npz")
    ttr.save_checkpoint(path, st)
    assert tio.load_payload(path)["theta::bfloat16"].dtype.str == "|V2"
    back, _ = ttr.load_checkpoint(path, ttr.init_state(1, params=params))
    assert back.theta["bfloat16"].dtype == torch.bfloat16
    a, b = tio.entries(st.state_dict()), tio.entries(back.state_dict())
    _assert_bit_equal(a, b, sorted(a))

    # the reference facade's own bf16 file, which the reference cannot
    # restore (src/repro/checkpoint/io.py:100), loads into the port
    jparams = {k: (v.astype(jnp.bfloat16) if k.startswith("w") else v)
               for k, v in _jparams().items()}
    jtr = JTrainer(engine="sim", protocol=JProto(**PROTO), optimizer=JOpt(**CASES["nag"][0]),
                   loss_fn=_jloss, num_workers=W)
    jst = jtr.init_state(0, params=jparams)
    jpath = str(tmp_path / "ref_mixed.npz")
    jtr.save_checkpoint(jpath, jst)
    got, _ = ttr.load_checkpoint(jpath, ttr.init_state(1, params=params))
    want = np.asarray(jst.theta["bfloat16"]).view(np.uint16)
    assert np.array_equal(got.theta["bfloat16"].view(torch.int16).numpy().view(np.uint16), want)


def test_restore_refusals(tmp_path):
    """A manifest that differs from the target's layout, a sharded file and
    a wrongly shaped entry refuse with the reference's messages; a missing
    optional proto field keeps the template's value."""
    _, ttr = _trainers("nag")
    st = ttr.init_state(0, params=_tparams())
    path = str(tmp_path / "ck.npz")
    ttr.save_checkpoint(path, st)
    renamed = {"renamed_" + k: v for k, v in _tparams().items()}
    like = st.replace(spec=FlatSpec.build({k: v[None] for k, v in renamed.items()}, leading=1))
    with pytest.raises(ValueError, match="manifest does not match"):
        tio.restore_state(path, like)
    meta = tio.load_meta(path)
    meta["shard"] = {"n_shards": 2, "axes": ["fsdp"], "quantum": 128}
    tio.save_state(path, st, meta=meta)
    with pytest.raises(ValueError, match="written under a sharded plane"):
        ttr.load_checkpoint(path, st)
    small = _trainers("nag")[1]
    other = small.init_state(0, params={k: v[..., :1] if v.ndim == 1 else v
                                        for k, v in _tparams().items()})
    ttr.save_checkpoint(path, st)
    with pytest.raises(ValueError, match="manifest does not match"):
        small.load_checkpoint(path, other)
    with pytest.raises(ValueError, match="has shape"):
        tio.restore(path, {"theta": {"float32": torch.zeros(3, 5)}})
    # a template with fault counters, a file without them
    zero = torch.zeros((), dtype=torch.int32)
    faulty = st.replace(proto=st.proto._replace(wire_dropped=zero + 7, wire_corrupt=zero + 9))
    back = tio.restore_state(path, faulty)
    assert int(back.proto.wire_dropped) == 7 and int(back.proto.wire_corrupt) == 9


def test_a_save_cut_short_is_refused(tmp_path, monkeypatch):
    """A save leaves only the file and its metadata. A save over an existing
    file that stops between its two renames (the metadata is renamed first)
    leaves the new metadata beside the old payload: the load refuses it by
    the step the metadata names, and the old file restores without it."""
    _, ttr = _trainers("nag")
    st = ttr.init_state(0, params=_tparams())
    path = str(tmp_path / "ck.npz")
    ttr.save_checkpoint(path, st, meta={"step": 0})
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.meta.json"]
    later = st.replace(step=st.step + 5)
    real = os.replace

    def cut(src, dst):
        if dst == path:
            raise OSError("cut short")
        real(src, dst)

    monkeypatch.setattr(os, "replace", cut)
    with pytest.raises(OSError, match="cut short"):
        ttr.save_checkpoint(path, later, meta={"step": 5})
    monkeypatch.undo()
    assert tio.load_meta(path)["step"] == 5
    with pytest.raises(ValueError, match="a save cut short"):
        ttr.load_checkpoint(path, st)
    back = tio.restore_state(path, st, meta={})
    assert int(back.step) == 0


def test_latest_step_path_and_schedule_meta(tmp_path):
    assert tio.latest_step_path(str(tmp_path / "missing")) is None
    _, ttr = _trainers("nag")
    st = ttr.init_state(0, params=_tparams())
    for step in (3, 12, 7):
        ttr.save_checkpoint(str(tmp_path / f"step_{step}.npz"), st)
    assert tio.latest_step_path(str(tmp_path)) == (12, str(tmp_path / "step_12.npz"))
    assert tio.load_meta(str(tmp_path / "none.npz")) is None
    assert ttr.schedule_state() == {} and ttr.num_workers == W
    assert not tio.restore_schedule(str(tmp_path / "step_3.npz"), None)


# ---------------------------------------------------------------------------
# resumes within the port
# ---------------------------------------------------------------------------

def _own_draw_run(ttr, st, batches, record):
    """Steps with the port's own draws; ``record`` gets each step's gate and
    peers, replayed from a copy of the generator (what the step draws)."""
    cfg = ttr.protocol
    for x, y in batches:
        probe = torch.Generator()
        probe.set_state(st.key.get_state())
        gate = tprotocols.comm_gate(cfg, probe, st.step, W)
        peers = ttr.impl.sample_peers(probe, W)
        record.append((gate.numpy().copy(), peers.numpy().copy()))
        st, m = ttr.step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        assert int(m["comm_active"]) == int(gate.sum())
    return st


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resume_continues_the_uninterrupted_run_bit_for_bit(case, tmp_path):
    """Save after 3 steps of the port's own draws, load into a trainer state
    built from another seed, take 3 more: every entry (theta, moments,
    residual, counters, the generator) and every gate and peer equal the
    uninterrupted run's."""
    _, ttr = _trainers(case)
    batches = _data()
    straight, resumed = [], []
    st = _own_draw_run(ttr, ttr.init_state(0, params=_tparams()), batches[:STEPS], straight)
    path = str(tmp_path / "mid.npz")
    ttr.save_checkpoint(path, st)
    saved = tio.entries(st.state_dict())
    st = _own_draw_run(ttr, st, batches[STEPS:], straight)
    _, ttr2 = _trainers(case)
    st2, _ = ttr2.load_checkpoint(path, ttr2.init_state(5, params=_tparams()))
    _assert_bit_equal(tio.entries(st2.state_dict()), saved, sorted(saved))
    st2 = _own_draw_run(ttr2, st2, batches[STEPS:], resumed)
    for (ga, pa), (gb, pb) in zip(straight[STEPS:], resumed):
        assert np.array_equal(ga, gb) and np.array_equal(pa, pb)
    a, b = tio.entries(st.state_dict()), tio.entries(st2.state_dict())
    _assert_bit_equal(a, b, sorted(a))


def test_a_generator_of_another_device_type_reseeds_from_key(tmp_path):
    """The saved generator state belongs to its device type (a CUDA
    generator's is a seed and an offset): a file whose ``torch_key`` is
    another device's, or that has none (the reference's), reseeds from
    ``key`` and the step, deterministically and away from the first draws."""
    _, ttr = _trainers("nag")
    st = ttr.init_state(0, params=_tparams())
    x, y = _data()[0]
    st, _ = ttr.step(st, (torch.from_numpy(x), torch.from_numpy(y)))
    path = str(tmp_path / "ck.npz")
    ttr.save_checkpoint(path, st)
    payload = tio.load_payload(path)
    gen_cpu = payload.pop("torch_key::cpu")
    payload["torch_key::cuda"] = np.arange(16, dtype=np.uint8)
    moved = str(tmp_path / "moved.npz")
    tio._write_npz(moved, payload)
    with open(moved + ".meta.json", "w") as f, open(path + ".meta.json") as g:
        f.write(g.read())
    back, _ = ttr.load_checkpoint(moved, ttr.init_state(3, params=_tparams()))
    want = generator_from_key(payload["key"], 1, "cpu")
    assert torch.equal(back.key.get_state(), want.get_state())
    assert not torch.equal(back.key.get_state(), torch.from_numpy(gen_cpu))
    fresh = torch.Generator().manual_seed(0)
    assert not torch.equal(torch.rand(8, generator=want), torch.rand(8, generator=fresh))
    # the same file and device type: the saved state itself
    same, _ = ttr.load_checkpoint(path, ttr.init_state(3, params=_tparams()))
    assert torch.equal(same.key.get_state(), torch.from_numpy(gen_cpu))


@pytest.mark.parametrize("codec", ["none", "topk"])
def test_dist_resume_on_two_gloo_ranks_is_bit_exact(codec, tmp_path):
    """Two ranks train 6 steps, saving at step 3 (rank 0 writes the whole
    [2, total] plane after a gather); fresh trainers on both ranks load it,
    each its own row, and take the last 3 steps: the loaded state equals
    the saved one and the end state the uninterrupted run's, bit for bit,
    with equal metrics on every step."""
    mesh = TMesh(data=2, model=1, pods=1, workers_per_pod=2)
    x = np.stack([b[0][:2] for b in _data()]).astype(np.float32)
    y = np.stack([b[1][:2] for b in _data()])
    params = jax.tree.map(np.asarray, _jparams())
    path = str(tmp_path / "dist.npz")
    run = dict(kind="resume", tag="resume", protocol=dict(PROTO, comm_probability=0.6),
               optimizer=CASES["nag"][0], codec=codec, steps=2 * STEPS, seed=0,
               at=STEPS, path=path)
    ranks = dist_run.run_fleet(mesh, "cpu", dict(params=params, x=x, y=y, runs=[run]),
                               timeout_s=60, join_timeout_s=240,
                               rendezvous_dir=str(tmp_path))
    for rk in ranks:
        r = rk["runs"][0]
        assert r["loaded_diff"] == [] and r["final_diff"] == [], r
        assert r["metrics_equal"]
    entries = ranks[0]["runs"][0]["entries"]
    total = entries["theta::float32"][0][1]
    want = {"theta::float32": ([2, total], "<f4"), "opt::mu::float32": ([2, total], "<f4"),
            "opt::step": ([], "<i4"), "step": ([], "<i4")}
    if codec == "topk":
        want["comm::residual::float32"] = ([2, total], "<f4")
    assert entries == want
    meta = ranks[0]["runs"][0]["meta"]
    assert {"protocol", "format", "flat_spec", "schedule", "comm_bytes", "step"} <= set(meta)
    assert meta["flat_spec"]["lead_shape"] == [2]
    assert os.path.exists(path + ".meta.json")
