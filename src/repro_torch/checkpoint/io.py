"""Checkpointing: flat-key npz + json metadata (port of
``repro.checkpoint.io``).

The format is the reference's file, so a checkpoint written by either
package loads in the other:

- **v2 (flat-resident)**: :func:`save_state` / :func:`restore_state` persist
  a :class:`repro_torch.api.state.FlatState` as its flat buffers (one
  ``[W, total]`` array per dtype bucket under paths like
  ``theta::float32``), with the FlatSpec manifest (leaf paths, offsets,
  shapes, dtypes) in the ``.meta.json`` beside the file.
- **v1 (legacy pytree)**: :func:`save` / :func:`restore`, one npz entry per
  tree leaf. :func:`restore_state` converts a v1 payload bit-exactly into
  the requested FlatState.

Entry names join the tree path with ``::`` as the reference's
``jax.tree_util`` paths do: a dict key by its name, a NamedTuple field as
``.field``, a sequence item by its index. A file holds numpy arrays with the
reference's dtypes. A bfloat16 array, which numpy lacks, is written as its
raw 16-bit patterns under the reference's ``<V2`` descriptor, byte for byte
the reference's ``.npy`` member; on read a ``V2`` (or an ``ml_dtypes``
bfloat16) array is turned back into bits, never through float values.

``schedule=`` stores a :class:`~repro_torch.core.scheduler.GossipSchedule`'s
``state()`` in the metadata, and :func:`restore_schedule` rewinds a
schedule from it. ``GossipTrainer.save_checkpoint`` / ``load_checkpoint``
call these.
"""
from __future__ import annotations

import io as _io
import json
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.state import OPTIONAL_PROTO_FIELDS
from repro_torch.common.flat import dtype_name
from repro_torch.common.pytree import tree_unflatten

PyTree = Any
SEP = "::"

FLAT_FORMAT = 2       # checkpoint format version written by save_state

# optional FlatState payload keys: proto fields that engines not using them
# leave out (the async engine's virtual time, the fault and fleet planes);
# a restore into a template that has them keeps the template's values
VIRTUAL_TIME_KEYS = tuple(f"proto{SEP}{k}" for k in OPTIONAL_PROTO_FIELDS)

# the reference writes bfloat16 (ml_dtypes) arrays with this descriptor
_BF16_DESCR, _VOID_DESCR = b"'descr': '<V2'", b"'descr': '|V2'"


# ---------------------------------------------------------------------------
# the npz form
# ---------------------------------------------------------------------------

def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path key, child) pairs of a container in the reference's flatten
    order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _flatten(tree: PyTree, prefix: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {SEP.join(prefix) or "_root": _to_numpy(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, sub in kids:
        flat.update(_flatten(sub, prefix + (k,)))
    return flat


def entries(tree: PyTree) -> Dict[str, np.ndarray]:
    """The entries :func:`save` writes for ``tree``, as numpy copies (to
    compare states bit for bit)."""
    return {k: v.copy() for k, v in _flatten(tree).items()}


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = _io.BytesIO()
    np.lib.format.write_array(buf, arr, allow_pickle=False)
    data = buf.getvalue()
    if arr.dtype == np.dtype("V2"):
        # a 2-byte void array is a bfloat16 plane: the reference's header
        # names it '<V2' (same length, so the padding is unchanged)
        head = data.index(b"\n") + 1
        data = data[:head].replace(_VOID_DESCR, _BF16_DESCR, 1) + data[head:]
    return data


def _write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """``np.savez``'s layout (stored, one ``<key>.npy`` member per entry)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fh:
                fh.write(_npy_bytes(arr))


def _bf16_bits(arr: np.ndarray) -> Optional[np.ndarray]:
    """The int16 bit patterns of a bfloat16 array read from a file (``V2``,
    or ``ml_dtypes.bfloat16`` where that is installed), else None."""
    if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V" or arr.dtype.name == "bfloat16"):
        return np.require(arr, requirements="C").view(np.int16)
    return None


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def to_tensor(arr: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A file's array as a tensor on ``device`` (cast to ``dtype`` if given);
    bfloat16 planes go through their bits."""
    bits = _bf16_bits(arr)
    if bits is not None:
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    elif dtype is not None and dtype != torch.bfloat16:
        t = torch.from_numpy(np.array(arr, dtype=_numpy_dtype(dtype)))
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _restore_flat(flat: Dict[str, np.ndarray], like: PyTree,
                  missing_ok: Tuple[str, ...] = (), prefix: Tuple[str, ...] = ()):
    """``like``'s structure filled from ``flat`` (shapes checked)."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        key = SEP.join(prefix) or "_root"
        if key not in flat and any(key == m or key.startswith(m + SEP) for m in missing_ok):
            return like
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint entry {key!r} has shape {tuple(arr.shape)}, "
                             f"the target expects {tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            return to_tensor(arr, like.device, like.dtype)
        return np.asarray(arr, dtype=np.asarray(like).dtype)
    vals = [_restore_flat(flat, sub, missing_ok, prefix + (k,)) for k, sub in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def save(path: str, tree: PyTree, meta: Optional[dict] = None,
         schedule=None) -> None:
    """Save a tree of tensors / numpy arrays; ``schedule`` (a GossipSchedule)
    is persisted into the metadata so :func:`restore_schedule` can rewind it
    on resume. Each file is written to a temporary name and renamed into
    place, the metadata first: a save cut short leaves either no new file,
    or a new ``.meta.json`` beside the payload it would replace, which
    :func:`restore_state` refuses when the metadata names a ``step``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if schedule is not None:
        meta = dict(meta or {})
        meta["schedule"] = schedule.state()
    tmp = path + ".tmp.npz"
    _write_npz(tmp, _flatten(tree))
    if meta is not None:
        with open(tmp + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)
        os.replace(tmp + ".meta.json", path + ".meta.json")
    os.replace(tmp, path)


def load_payload(path: str) -> Dict[str, np.ndarray]:
    """Raw flat-key payload of a checkpoint npz, exactly as written (v2 keys
    are whole planes like ``theta::float32``)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def restore(path: str, like: PyTree, missing_ok: Tuple[str, ...] = ()) -> PyTree:
    """Restore into the structure of ``like`` (shapes checked, values cast to
    ``like``'s dtypes and put on its devices). ``missing_ok``: key prefixes
    that may be absent from the payload; those leaves keep ``like``'s
    values."""
    return _restore_flat(load_payload(path), like, missing_ok)


# ---------------------------------------------------------------------------
# checkpoint v2: flat-resident FlatState payloads + FlatSpec manifest
# ---------------------------------------------------------------------------

def _leaf_keys(spec) -> List[str]:
    """Per-slot path keys of the spec's parameter tree, flatten order
    (the v1 per-leaf npz keys under any given prefix)."""
    def walk(d, prefix):
        kind = d[0]
        if kind == "leaf":
            return [SEP.join(prefix)]
        if kind == "none":
            return []
        names = d[1] if kind == "dict" else [str(i) for i in range(d[1])]
        return [k for name, sub in zip(names, d[2]) for k in walk(sub, prefix + [str(name)])]
    return walk(spec.treedef, [])


def flat_spec_manifest(spec) -> dict:
    """JSON-serializable description of a FlatSpec: enough to locate every
    parameter inside the saved flat buffers without the producing code."""
    return {
        "leading": spec.leading,
        "lead_shape": list(spec.lead_shape),
        "align": spec.align,
        "totals": {k: int(n) for k, n in spec.totals.items()},
        "slots": [{"path": key, "bucket": s.bucket, "offset": s.offset,
                   "size": s.size, "shape": list(s.shape), "dtype": dtype_name(s.dtype)}
                  for key, s in zip(_leaf_keys(spec), spec.slots)],
    }


def check_manifest(meta: Optional[dict], spec, path: str = "") -> None:
    """Raise unless ``meta``'s FlatSpec manifest (if any) matches ``spec``:
    slicing a saved plane with another layout would scramble parameters."""
    saved = (meta or {}).get("flat_spec")
    if saved is not None and saved != flat_spec_manifest(spec):
        raise ValueError(
            "checkpoint FlatSpec manifest does not match the target "
            "state's layout (parameter tree renamed/reordered/resized "
            "since the checkpoint was written?) — refusing to slice the "
            f"saved plane with a different layout: {path}")


def save_state(path: str, state, meta: Optional[dict] = None,
               schedule=None) -> None:
    """Persist a FlatState in checkpoint format v2: its flat buffers under
    named paths, the FlatSpec manifest (and optionally the gossip schedule)
    in the metadata."""
    meta = dict(meta or {})
    meta["format"] = FLAT_FORMAT
    meta["flat_spec"] = flat_spec_manifest(state.spec)
    save(path, state.state_dict(), meta=meta, schedule=schedule)


def _legacy_to_state(flat: Dict[str, np.ndarray], like):
    """Convert a v1 per-leaf payload (the SimState era's ``{params, opt(step,
    mu, nu), proto, key, step, comm}`` or the dist engine's ``{params,
    velocity, center, step, comm}``) into ``like``'s FlatState, bit-exactly."""
    from repro_torch.api.state import generator_from_key
    spec = like.spec
    leaf_keys = _leaf_keys(spec)
    dev = like.step.device

    def tree_bufs(prefix: str, lead: bool = True):
        keys = [prefix + SEP + k if k else prefix for k in leaf_keys]
        if not all(k in flat for k in keys):
            return None
        tree = tree_unflatten(spec.treedef, [to_tensor(flat[k], dev) for k in keys])
        return (spec if lead else spec.with_lead(())).flatten(tree)

    def scalar(key, ref):
        return to_tensor(flat[key], ref.device, ref.dtype) if key in flat else ref

    theta = tree_bufs("params")
    if theta is None:
        raise ValueError("legacy checkpoint is missing the params tree")
    # the sim engine stored the velocity as the opt NamedTuple's ``mu``
    # (keys ``opt::.mu::<leaf>``), the dist engine as ``velocity``
    mu = tree_bufs("velocity")
    if mu is None:
        mu = tree_bufs(f"opt{SEP}.mu")
    if mu is None and getattr(like.opt, "mu", None):
        raise ValueError("legacy checkpoint is missing the velocity tree")
    nu = tree_bufs(f"opt{SEP}.nu")
    # the dist v1 layout had no optimizer step of its own
    opt = type(like.opt)(scalar(f"opt{SEP}.step", scalar("step", like.opt.step)),
                         mu if mu is not None else {}, nu if nu is not None else {})
    proto = like.proto
    if proto is not None:
        proto = proto._replace(
            center=tree_bufs(f"proto{SEP}.center", lead=False),
            comm_rounds=scalar(f"proto{SEP}.comm_rounds", proto.comm_rounds),
            comm_units=scalar(f"proto{SEP}.comm_units", proto.comm_units),
            comm_bytes=scalar(f"proto{SEP}.comm_bytes", proto.comm_bytes))
    comm = like.comm
    if comm is not None and getattr(comm, "residual", None) is not None:
        comm = type(comm)(tree_bufs(f"comm{SEP}.residual"))
    center = tree_bufs("center", lead=False) if like.center is not None else None
    step = scalar("step", like.step)
    key = like.key
    if key is not None and "key" in flat:
        key = generator_from_key(flat["key"], int(step), key.device)
    return like.replace(theta=theta, opt=opt, proto=proto, comm=comm,
                        center=center, key=key, step=step)


def restore_state(path: str, like, meta: Optional[dict] = None, row: Optional[int] = None):
    """Restore a checkpoint into the FlatState structure of ``like``.

    The generation comes from ``meta['format']`` (pass an already-loaded
    ``meta`` to skip re-reading it); without metadata a ``theta::<bucket>``
    key marks v2. v1 payloads convert through :func:`_legacy_to_state`.

    ``row``: the dist engine's rank. ``like`` is then one rank's ``[1,
    total]`` row of a file holding the whole ``[W, total]`` plane; the
    manifest is checked against the ``W``-row layout and every plane is cut
    to row ``row`` before it is restored."""
    if meta is None:
        meta = load_meta(path) or {}
    flat = load_payload(path)
    if "step" in meta and "step" in flat and int(meta["step"]) != int(flat["step"]):
        raise ValueError(f"checkpoint metadata names step {meta['step']} but the payload "
                         f"holds step {int(flat['step'])} (a save cut short?): {path}")
    fmt = meta.get("format")
    if fmt is None:
        fmt = FLAT_FORMAT if any(k.startswith("theta" + SEP) or k == "theta"
                                 for k in flat) else 1
    if int(fmt) < FLAT_FORMAT:
        if row is not None:
            raise ValueError("a v1 checkpoint cannot restore one dist rank's row")
        return _legacy_to_state(flat, like)
    spec = like.spec
    if row is not None:
        rows = int(flat[next(k for k in flat if k.startswith("theta" + SEP))].shape[0])
        spec = spec.with_lead((rows,))
        flat = {k: (v[row:row + 1] if v.ndim == 2 and v.shape[0] == rows
                    and k.split(SEP)[0] in ("theta", "opt", "comm") else v)
                for k, v in flat.items()}
    check_manifest(meta, spec, path)
    tmpl = like.state_dict()
    # the generator's own state: read by the port only, for the device type
    # it was taken on (absent from the reference's files)
    has_gen = tmpl.pop("torch_key", None) is not None
    d = _restore_flat(flat, tmpl, missing_ok=VIRTUAL_TIME_KEYS)
    if has_gen:
        pre = "torch_key" + SEP
        d["torch_key"] = {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}
    return like.from_state_dict(d)


def restore_schedule(path: str, schedule) -> bool:
    """Rewind a GossipSchedule to the position saved alongside the
    checkpoint at ``path``. Returns True when schedule state was present."""
    meta = load_meta(path)
    if meta and meta.get("schedule"):
        schedule.restore(meta["schedule"])
        return True
    return False


def load_meta(path: str) -> Optional[dict]:
    mp = path + ".meta.json"
    if os.path.exists(mp):
        with open(mp) as f:
            return json.load(f)
    return None


def latest_step_path(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".npz"):
            step = int(name[len("step_"):-len(".npz")])
            if best is None or step > best[0]:
                best = (step, os.path.join(ckpt_dir, name))
    return best
