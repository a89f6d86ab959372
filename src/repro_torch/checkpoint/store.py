"""Atomic checkpoint store (port of ``repro.checkpoint.store``, the part
``serving.snapshot`` uses).

Layout: <dir>/step_<N>/  one .npy per flattened tree path + index.json.
Writes go to a tmp dir and are renamed into place (atomic on POSIX), so
a crash mid-save never corrupts the latest checkpoint.  Every data file
and the index are fsync'd BEFORE the rename, and the parent directory
is fsync'd after it: without the former, a power loss can leave a
fully-renamed step whose file contents never hit the disk
(rename-before-data), which no amount of tmp-dir discipline catches.

A tree is dicts (sorted keys), lists and tuples over host arrays; its
paths are the JAX store's (``meta``, ``leaves§0``, ...), so the two
stores read each other's steps.  Leaf file names come from Python's
``hash`` of the path, which is salted per process: compare index
contents and leaves across processes, not file names.  Without
``ml_dtypes`` a step whose index names ``bfloat16`` or a float8 type
does not load (``load_flat`` raises).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

_SEP = "§"

# Logical dtypes the JAX store writes as same-width integer views; numpy
# alone cannot view them back.
_VIEWED = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _flatten(tree, path: tuple = ()) -> dict:
    """``{"a§0§b": leaf, ...}``: dict keys sorted, list and tuple
    entries by index, None no leaf, every other object a leaf."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {_SEP.join(path): tree}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, path + (str(key),)))
    return flat


def _write_fsync(path: str, writer) -> None:
    """Write through ``writer(f)`` and fsync before close, so the bytes
    are durable BEFORE the enclosing tmp dir is renamed into place."""
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Synchronous atomic save of a tree of host arrays.  Returns the
    final directory."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = {}
    for key, leaf in flat.items():
        arr = np.asarray(leaf)
        fname = f"{abs(hash(key)) & 0xFFFFFFFF:08x}.npy"
        _write_fsync(os.path.join(tmp, fname),
                     lambda f, a=arr: np.save(f, a))
        index[key] = {"file": fname, "shape": list(arr.shape),
                      "dtype": str(arr.dtype)}
    _write_fsync(os.path.join(tmp, "index.json"),
                 lambda f: f.write(json.dumps(
                     {"step": step, "leaves": index}).encode()))
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def list_steps(ckpt_dir: str) -> list[int]:
    """Completed (renamed, indexed) step numbers, ascending.  In-flight
    ``.tmp`` dirs from a crashed save are never listed — a torn write
    is invisible here, not a corrupt restore candidate."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "index.json")))


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_flat(ckpt_dir: str, step: int) -> dict:
    """Load every leaf of one step keyed by its flattened tree path —
    no ``like`` tree required (the snapshot layer reconstructs its own
    structure from an embedded manifest).  Raises on missing/truncated
    files and on leaves numpy cannot represent; callers that need
    graceful fallback (serving.snapshot) catch and step back to an
    older snapshot."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)["leaves"]
    out = {}
    for key, meta in index.items():
        if meta["dtype"] in _VIEWED:
            raise ValueError(f"checkpoint leaf {key!r} is {meta['dtype']}, "
                             "which needs ml_dtypes")
        out[key] = np.load(os.path.join(d, meta["file"]))
    return out
