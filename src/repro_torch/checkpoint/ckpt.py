"""Flat-key npz checkpoints with a round trip of the tree's structure.

The port of ``repro.checkpoint.ckpt``, in its file format: one npz entry
per leaf under its ``/``-joined path (dict keys, list and tuple indices,
named-tuple field names: ``params/layers/0/wq``, ``opt/mu/embed``), and
``__meta__``, a JSON string with ``step`` and the sorted ``keys``.  Either
package reads what the other writes.

numpy has no bfloat16, so a bf16 leaf is stored widened to f32 (exact) and
its key is listed under ``bfloat16`` in ``__meta__``; loading narrows it
back, so it round-trips bit for bit.  The reference ignores the list and
reads the f32 values.

The file is the one ``np.savez`` writes (stored ``.npy`` members), but
written and read one leaf at a time in 8 MiB pieces, straight from and
into the arrays' memory (numpy's reader takes 256 KiB at a time);
``zipfile`` checks each member's CRC-32 as it is read.  A leaf's copy to
the host overlaps the writing of the one before; leaves load in parallel
threads.
"""
from __future__ import annotations

import json
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

SEP = "/"


def _with_paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf, in the tree's order."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield SEP.join(prefix), tree
        return
    for name, sub in items:
        yield from _with_paths(sub, prefix + (name,))


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken from ``leaves`` in order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


#: Bytes per read or write call.
_PIECE = 8 << 20
#: Leaves read at once by load_checkpoint.
_LOAD_THREADS = 4


def _pieces(arr: np.ndarray) -> Iterator[memoryview]:
    """The array's bytes (C order) as views of at most ``_PIECE`` bytes."""
    flat = memoryview(arr.reshape(-1).view(np.uint8))
    for start in range(0, arr.nbytes, _PIECE):
        yield flat[start:start + _PIECE]


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """One ``key.npy`` member: the .npy header ``np.save`` writes, then the
    array's bytes."""
    arr = np.asarray(arr, order="C")
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(
            f, np.lib.format.header_data_from_array_1_0(arr))
        for piece in _pieces(arr):
            f.write(piece)


_NPY_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _read_member(path: str, name: str) -> np.ndarray:
    """The array of the C-order ``.npy`` member ``name``."""
    with zipfile.ZipFile(path) as zf, zf.open(name) as f:
        shape, fortran, dtype = _NPY_HEADERS[np.lib.format.read_magic(f)](f)
        if fortran or dtype.hasobject:
            raise ValueError(f"{name}: not a C-order array of plain values")
        arr = np.empty(shape, dtype)
        for piece in _pieces(arr):
            if f.readinto(piece) != len(piece):
                raise ValueError(f"{name}: truncated")
        if f.read(1):
            raise ValueError(f"{name}: trailing bytes")
    return arr


def _host_array(leaf) -> Tuple[np.ndarray, bool]:
    """A leaf as a numpy array on the host, and whether it was bf16
    (widened to f32, exactly)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), False
    leaf = leaf.detach()
    bf16 = leaf.dtype == torch.bfloat16
    return (leaf.float() if bf16 else leaf).cpu().numpy(), bf16


def save_checkpoint(path: str, tree, *, step: Optional[int] = None) -> None:
    """Write every leaf of ``tree`` (tensors on any device, numpy arrays or
    numbers) to the npz file ``path`` (``.npz`` is appended where the name
    lacks it, as ``np.savez`` does).  Leaves are written one at a time,
    each one's copy to the host made while the one before is written, so
    the host holds at most two leaves' copies rather than the whole
    tree's."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not path.endswith(".npz"):
        path += ".npz"
    items = list(_with_paths(tree))
    bf16 = []
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf, ThreadPoolExecutor(1) as pool:
        pending = pool.submit(_host_array, items[0][1]) if items else None
        for i, (key, _) in enumerate(items):
            arr, was_bf16 = pending.result()
            if i + 1 < len(items):
                pending = pool.submit(_host_array, items[i + 1][1])
            _write_member(zf, key, arr)
            del arr
            if was_bf16:
                bf16.append(key)
        meta = {"step": step, "keys": sorted(key for key, _ in items)}
        if bf16:
            meta["bfloat16"] = sorted(bf16)
        _write_member(zf, "__meta__", np.asarray(json.dumps(meta)))


def load_checkpoint(path: str, target_tree, *,
                    device: "str | torch.device" = "cuda"):
    """Read ``path`` into the structure of ``target_tree`` (its leaves give
    the keys and shapes; their values are not used): returns (the tree of
    tensors on ``device``, in the stored dtypes, the stored step).
    ``KeyError`` for a key the file lacks, ``ValueError`` for a shape that
    differs from the target leaf's."""
    with zipfile.ZipFile(path) as zf:
        members = {name[:-len(".npy")] for name in zf.namelist()
                   if name.endswith(".npy")}
    meta = json.loads(str(_read_member(path, "__meta__.npy")))
    bf16 = set(meta.get("bfloat16", ()))
    wanted = list(_with_paths(target_tree))
    for key, _ in wanted:
        if key not in members:
            raise KeyError(f"checkpoint missing {key}")

    def load(item):
        key, leaf = item
        arr = _read_member(path, key + ".npy")
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(np.shape(leaf))}")
        t = torch.from_numpy(arr)
        if key in bf16:
            t = t.to(torch.bfloat16)
        return t.to(device)

    with ThreadPoolExecutor(_LOAD_THREADS) as pool:
        out = list(pool.map(load, wanted))
    return _rebuild(target_tree, iter(out)), meta.get("step")
