"""Checkpointing: the port of ``repro/checkpoint/io.py``, file for file.

Layout: ``<dir>/step_<N>/arrays.npz`` (leaves ``a0..an``) + ``tree.json``
(``treedef``, ``n``, ``dtypes``, ``shapes``). Works for any tree of tensors
(dicts, lists, tuples, named tuples): params, optimizer states, MBRL
worker states. Keeps the last ``keep`` steps. A snapshot written here
loads in the reference and the other way round.

Leaf order. The file's leaves are positional, and the reference numbers
them in ``jax.tree.flatten`` order, which visits a dict's keys SORTED
(``repro_torch.utils.tree`` visits them in insertion order). The MBRL trees
are ``{"w": [...], "b": [...]}``; read in insertion order, a reference
snapshot would land with ``w`` and ``b`` swapped wherever their shapes
agree. So this module flattens and rebuilds trees in the reference's order
(:func:`flatten`), and a rebuilt dict keeps the template's key order.

bf16 (and float8 e4m3) cannot go through ``np.savez``: the reference stores
them as same-width unsigned integers through ``ml_dtypes`` and writes the
dtype's name (``"bfloat16"``) in ``dtypes``. Here the same bits come from
torch's own dtype views, so no ``ml_dtypes`` is needed.

Crash-atomic, as the reference: every snapshot is written to a ``.tmp``
sibling first (each file flushed and fsynced), the directory is renamed
over the target in one ``os.replace`` and the parent directory fsynced, so
a writer killed at any instruction leaves the previous complete snapshot
and at most an ignorable ``.tmp`` leftover, which the next save sweeps.
``restore`` falls back to the newest snapshot that loads.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)$")

# dtypes np.savez cannot hold: stored as same-width integers, named by the
# reference's (ml_dtypes') dtype name
_EXOTIC = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
           torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8)}
_EXOTIC_BY_NAME = {name: (dt, view, store)
                   for dt, (name, view, store) in _EXOTIC.items()}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order: dict keys
    sorted, lists and tuples in order, ``None`` an empty subtree."""
    out: List[Any] = []

    def visit(x):
        if isinstance(x, dict):
            for k in sorted(x):
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif x is not None:
            out.append(x)
    visit(tree)
    return out


def unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in the order of
    :func:`flatten`; its dicts keep ``like``'s key order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            vals = {k: build(x[k]) for k in sorted(x)}
            return {k: vals[k] for k in x}
        if _is_namedtuple(x):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if x is None:
            return None
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _treedef(tree) -> str:
    """A description of the structure in the style of JAX's ``PyTreeDef``
    (informational: neither package reads it back)."""
    def desc(x):
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {desc(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return f"{type(x).__name__}(" + ", ".join(
                f"{f}={desc(v)}" for f, v in zip(x._fields, x)) + ")"
        if isinstance(x, list):
            return "[" + ", ".join(desc(v) for v in x) + "]"
        if isinstance(x, tuple):
            return "(" + ", ".join(desc(v) for v in x) + ")"
        return "None" if x is None else "*"
    return f"PyTreeDef({desc(tree)})"


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        if x.dtype in _EXOTIC:
            return _EXOTIC[x.dtype][0]
        return str(torch.empty((), dtype=x.dtype).numpy().dtype)
    return str(np.asarray(x).dtype)


def _to_storable(x) -> np.ndarray:
    """One leaf on the host in a dtype ``np.savez`` holds."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype in _EXOTIC:
            _, view, store = _EXOTIC[t.dtype]
            return t.contiguous().view(view).numpy().view(store)
        return t.numpy()
    return np.asarray(x)


def _from_storable(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored array as a tensor of the named dtype on ``device``."""
    a = np.array(a)                     # writable, owned
    if dtype in _EXOTIC_BY_NAME:
        dt, view, store = _EXOTIC_BY_NAME[dtype]
        signed = np.int16 if store == np.uint16 else np.uint8
        return torch.from_numpy(a.view(signed)).view(dt).to(device)
    return torch.from_numpy(a.astype(np.dtype(dtype))).to(device)


def _device_of(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


class LeafCodec:
    """Flat-key codec for ONE tree structure: host-materialises leaves into
    their storable (npz-safe) dtypes and restores them. Structure, shapes,
    dtypes and devices are fixed at construction from a template, so encode
    and decode never re-derive them."""

    def __init__(self, template):
        self.template = template
        flat = flatten(template)
        self.dtypes = [_dtype_name(x) for x in flat]
        self.shapes = [tuple(x.shape) if hasattr(x, "shape")
                       else tuple(np.shape(x)) for x in flat]
        self.devices = [_device_of(x) for x in flat]
        self.storable_dtypes = [
            np.dtype(_EXOTIC_BY_NAME[d][2]) if d in _EXOTIC_BY_NAME
            else np.dtype(d) for d in self.dtypes]
        self.nbytes = [int(np.prod(s, dtype=np.int64)) * sd.itemsize
                       for s, sd in zip(self.shapes, self.storable_dtypes)]

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    def encode(self, tree) -> List[np.ndarray]:
        """Tree -> list of host arrays in storable dtypes (the one
        device->host hop)."""
        flat = flatten(tree)
        if len(flat) != self.n_leaves:
            raise ValueError(f"tree has {len(flat)} leaves, the codec's "
                             f"template {self.n_leaves}")
        return [np.ascontiguousarray(_to_storable(x)) for x in flat]

    def decode(self, flat_storable) -> Any:
        """List of storable arrays -> tree of tensors with the template's
        dtypes, shapes and devices."""
        leaves = [_from_storable(np.asarray(a).reshape(s), d, dev)
                  for a, d, s, dev in zip(flat_storable, self.dtypes,
                                          self.shapes, self.devices)]
        return unflatten(self.template, leaves)


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path) -> None:
    # a rename is only durable once the containing directory's entry is on
    # disk; some filesystems reject an O_RDONLY fsync: best effort there
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_pytree(path, tree, *, step: Optional[int] = None, keep: int = 3):
    """Save under ``path/step_<N>`` (or ``path`` itself if step is None).

    Crash-atomic: contents land in ``<target>.tmp`` (each file flushed and
    fsynced), the tmp dir is renamed over the target in one ``os.replace``,
    and the parent directory is fsynced. Stale ``.tmp`` leftovers of
    earlier crashes are swept on the next save with a step."""
    base = Path(path)
    target = base / f"step_{step:09d}" if step is not None else base
    tmp = target.with_name(target.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = flatten(tree)
    arrays = {f"a{i}": _to_storable(x) for i, x in enumerate(flat)}
    with open(tmp / "arrays.npz", "wb") as f:
        np.savez(f, **arrays)
        _fsync_file(f)
    with open(tmp / "tree.json", "w") as f:
        f.write(json.dumps({
            "treedef": _treedef(tree),
            "n": len(flat),
            "dtypes": [_dtype_name(x) for x in flat],
            "shapes": [list(a.shape) for a in arrays.values()],
        }))
        _fsync_file(f)
    if target.exists():
        shutil.rmtree(target)
    os.replace(tmp, target)
    _fsync_dir(target.parent)
    if step is not None and keep:
        for old in _step_dirs(base)[:-keep]:
            shutil.rmtree(base / f"step_{old:09d}")
        # crashed writers leave orphaned .tmp dirs; sweep any that are not
        # the snapshot just renamed away
        for leftover in base.glob("step_*.tmp"):
            if leftover.is_dir():
                shutil.rmtree(leftover, ignore_errors=True)
    return target


def load_pytree(path, like):
    """Load into the structure of ``like`` (a template tree): tensors of
    the file's dtypes, on the devices of ``like``'s leaves (the CPU for a
    leaf that is not a tensor). Raises ValueError when the file's leaf
    count or a shape disagrees with the template."""
    target = Path(path)
    meta = json.loads((target / "tree.json").read_text())
    flat_like = flatten(like)
    if meta["n"] != len(flat_like):
        raise ValueError(f"checkpoint has {meta['n']} leaves, template has "
                         f"{len(flat_like)}")
    out = []
    with np.load(target / "arrays.npz") as data:
        for i, tmpl in enumerate(flat_like):
            arr = data[f"a{i}"]
            want = tuple(tmpl.shape) if hasattr(tmpl, "shape") \
                else tuple(np.shape(tmpl))
            if arr.shape != want:
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, "
                                 f"template {want}")
            out.append(_from_storable(arr, meta["dtypes"][i],
                                      _device_of(tmpl)))
    return unflatten(like, out)


def _step_dirs(base: Path) -> List[int]:
    """Step numbers of EXACT ``step_<N>`` directories, ascending; ``.tmp``
    leftovers never match."""
    steps = []
    for p in base.glob("step_*"):
        m = _STEP_RE.fullmatch(p.name)
        if m and p.is_dir():
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(path) -> Optional[int]:
    steps = _step_dirs(Path(path))
    return steps[-1] if steps else None


def restore(path, like):
    """Load the newest ``step_<N>`` under ``path`` (or ``path`` itself):
    ``(tree, step)``, the tensors on ``like``'s devices.

    Candidate steps are tried newest first, and one that fails to load (a
    truncated ``arrays.npz``, a missing or garbled ``tree.json``) is
    skipped, so a restart lands on the latest COMPLETE checkpoint. Raises
    FileNotFoundError only when no complete snapshot exists."""
    base = Path(path)
    steps = _step_dirs(base)
    if not steps:
        return load_pytree(base, like), None
    last_err: Optional[Exception] = None
    for step in reversed(steps):
        try:
            return load_pytree(base / f"step_{step:09d}", like), step
        except Exception as e:        # truncated/corrupt: try the older one
            last_err = e
    raise FileNotFoundError(
        f"no complete checkpoint under {base} "
        f"(all of steps {steps} failed to load)") from last_err
