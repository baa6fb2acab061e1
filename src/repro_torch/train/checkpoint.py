"""Checkpoints of trees of tensors: one ``.npy`` file a leaf and a manifest.

Port of ``repro/train/checkpoint.py``, with its semantics:

- each leaf is written to its own ``.npy`` file, named by its path in the
  tree (``_flatten`` gives the reference's keys letter for letter: dict
  keys sorted, sequence indices, ``.field`` for an ``OptState`` field,
  joined by ``/``; a file name replaces ``/`` with ``__``);
- a manifest (``MANIFEST``) records the step and each leaf's file, shape
  and dtype, in msgpack's encoding;
- writes go to ``step_<step>.tmp`` and are published by ``os.rename``, so
  a crash mid-write never corrupts the latest checkpoint; the last
  ``keep`` are kept;
- an optional writer thread (``blocking=False``; :func:`wait_async` joins
  them all) keeps the training loop off the disk;
- restore validates the tree and every shape against the target and puts
  each leaf on the target leaf's device and dtype (the port's counterpart
  of the reference's ``device_put`` with the target's sharding).

A tree is nested dicts, lists and tuples of tensors, with ``OptState``
nodes; ``OptState.step`` (a Python int in the port) is saved as a 0-d
int32 array, as the reference's, and restored as an int. The files and
the manifest of a float32 or int32 tree are byte-equal to the
reference's, so either package restores the other's checkpoints.

Two things the reference takes from packages that the card's machine
lacks are written out here:

- the manifest codec: maps, strings, integers and lists in msgpack's
  encoding, byte-equal to ``msgpack.packb`` for what the manifest holds;
- bf16 leaves: numpy has no bf16 without ``ml_dtypes``. A bf16 leaf is
  written as its 16-bit patterns under the header the reference's
  ``np.save`` of an ``ml_dtypes.bfloat16`` array writes (descr ``<V2``),
  so the file equals the reference's byte for byte, and any 2-byte void
  file (the reference's included) is read back to a bf16 tensor bit for
  bit. This is a stated divergence: the reference cannot restore its own
  bf16 leaves (``jnp.asarray`` has no cast from the void dtype it reads
  back and raises ``ValueError``).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import struct
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.optim.optimizers import OptState

MANIFEST = "manifest.msgpack"
_BF16_DESCR = "<V2"   # what np.save writes for ml_dtypes' bfloat16


# ------------------------------------------------------------------ tree
def _items(node: Any):
    """(key, child) pairs in the order JAX flattens the node, or None for
    a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, OptState):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for key, child in items:
        flat.update(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return flat


def _rebuild(tree: Any, values: dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with the leaf at each key taken from
    ``values``."""
    items = _items(tree)
    if items is None:
        return values[prefix]
    sub = {key: _rebuild(child, values, f"{prefix}/{key}" if prefix else key)
           for key, child in items}
    if isinstance(tree, dict):
        return {k: sub[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub[str(i)] for i in range(len(tree)))
    return OptState(**{f.name: sub[f".{f.name}"]
                       for f in dataclasses.fields(tree)})


# -------------------------------------------------------------- manifest
def _pack(obj: Any) -> bytes:
    """msgpack's encoding of maps, strings, integers and lists (the
    smallest form of each, as ``msgpack.packb`` writes it)."""
    if isinstance(obj, int) and not isinstance(obj, bool):
        if 0 <= obj < 128:
            return struct.pack("B", obj)
        if -32 <= obj < 0:
            return struct.pack("b", obj)
        if obj >= 0:
            for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                  (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < top:
                    return bytes([tag]) + struct.pack(fmt, obj)
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if obj >= low:
                return bytes([tag]) + struct.pack(fmt, obj)
        raise OverflowError(obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            head = bytes([0xA0 | n])
        elif n < 1 << 8:
            head = b"\xd9" + struct.pack(">B", n)
        elif n < 1 << 16:
            head = b"\xda" + struct.pack(">H", n)
        else:
            head = b"\xdb" + struct.pack(">I", n)
        return head + raw
    if isinstance(obj, (list, tuple)):
        return _head(len(obj), 0x90, 0xDC) + b"".join(_pack(x) for x in obj)
    if isinstance(obj, dict):
        return _head(len(obj), 0x80, 0xDE) + b"".join(
            _pack(k) + _pack(v) for k, v in obj.items())
    raise TypeError(f"the manifest codec does not encode {type(obj).__name__}")


def _head(n: int, fix: int, tag16: int) -> bytes:
    """The header of an array (fix 0x90) or a map (fix 0x80) of n items."""
    if n < 16:
        return bytes([fix | n])
    if n < 1 << 16:
        return bytes([tag16]) + struct.pack(">H", n)
    return bytes([tag16 + 1]) + struct.pack(">I", n)


def _unpack(buf: bytes) -> Any:
    obj, end = _read(buf, 0)
    if end != len(buf):
        raise ValueError(f"manifest: {len(buf) - end} trailing bytes")
    return obj


def _read(buf: bytes, i: int) -> tuple[Any, int]:
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    if tag & 0xE0 == 0xA0:
        n = tag & 0x1F
        return buf[i:i + n].decode("utf-8"), i + n
    if tag & 0xF0 == 0x90:
        return _read_array(buf, i, tag & 0x0F)
    if tag & 0xF0 == 0x80:
        return _read_map(buf, i, tag & 0x0F)
    fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if tag in fixed:
        size = struct.calcsize(fixed[tag])
        return struct.unpack(fixed[tag], buf[i:i + size])[0], i + size
    lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
               0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if tag not in lengths:
        raise ValueError(f"manifest: msgpack type 0x{tag:02x} is not one "
                         "the manifest holds")
    size = struct.calcsize(lengths[tag])
    n = struct.unpack(lengths[tag], buf[i:i + size])[0]
    i += size
    if tag <= 0xDB:
        return buf[i:i + n].decode("utf-8"), i + n
    if tag <= 0xDD:
        return _read_array(buf, i, n)
    return _read_map(buf, i, n)


def _read_array(buf: bytes, i: int, n: int) -> tuple[list, int]:
    out = []
    for _ in range(n):
        x, i = _read(buf, i)
        out.append(x)
    return out, i


def _read_map(buf: bytes, i: int, n: int) -> tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _read(buf, i)
        out[k], i = _read(buf, i)
    return out, i


# ----------------------------------------------------------------- leaves
def _leaf_array(leaf: Any) -> tuple[np.ndarray, str]:
    """The leaf as a host array to write, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, dtype=np.int32)  # OptState.step
    else:
        raise TypeError(f"a checkpoint leaf is a tensor or an int, not "
                        f"{type(leaf).__name__}")
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _load_leaf(path: str, target: Any, key: str) -> Any:
    arr = np.load(path)
    want = tuple(target.shape) if isinstance(target, torch.Tensor) else ()
    if tuple(arr.shape) != want:
        raise ValueError(f"{key}: shape {arr.shape} != target {want}")
    if not isinstance(target, torch.Tensor):
        return int(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        value = torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        value = torch.from_numpy(np.ascontiguousarray(arr))
    return value.to(device=target.device, dtype=target.dtype)


# ---------------------------------------------------------------- writing
_ASYNC_WRITES: list[threading.Thread] = []


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3,
                    blocking: bool = True) -> str:
    """Write checkpoint ``directory/step_<step>``; returns the final path.

    The leaves are copied to host arrays before this returns, also with
    ``blocking=False``, so the caller may go on updating the tree."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    leaves = {key: _leaf_array(leaf) for key, leaf in _flatten(tree).items()}

    def _write():
        os.makedirs(tmp, exist_ok=True)
        meta = {"step": step, "leaves": {}}
        for key, (arr, dtype) in leaves.items():
            fname = key.replace("/", "__") + ".npy"
            _save_leaf(os.path.join(tmp, fname), arr, dtype)
            meta["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
        with open(os.path.join(tmp, MANIFEST), "wb") as f:
            f.write(_pack(meta))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _gc(directory, keep)

    if blocking:
        _write()
    else:
        t = threading.Thread(target=_write, name="checkpoint-writer",
                             daemon=True)
        t.start()
        _ASYNC_WRITES.append(t)
    return final


def wait_async() -> None:
    """Join every checkpoint writer thread started so far."""
    for t in _ASYNC_WRITES:
        t.join()
    _ASYNC_WRITES.clear()


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    """The newest published step under ``directory`` (a ``.tmp`` or a
    directory without a manifest does not count), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, MANIFEST))
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, target: Any,
                       step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``target`` (tree and shapes
    validated); each leaf lands on the target leaf's device and dtype.
    Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, MANIFEST), "rb") as f:
        meta = _unpack(f.read())

    flat_target = _flatten(target)
    missing = set(flat_target) - set(meta["leaves"])
    extra = set(meta["leaves"]) - set(flat_target)
    if missing or extra:
        raise ValueError(f"tree mismatch: missing={missing} extra={extra}")
    restored = {
        key: _load_leaf(os.path.join(path, meta["leaves"][key]["file"]),
                        leaf, key)
        for key, leaf in flat_target.items()
    }
    return _rebuild(target, restored), meta["step"]
