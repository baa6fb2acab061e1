"""The dry-run: every (arch x shape) cell counted on one card's terms.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell on 256 and 512 virtual devices and reads XLA's cost and memory
analyses. The port builds each cell on the ``meta`` device (shapes only;
``launch.cell``), runs one step under ``launch.count.Counter`` and writes
a record shaped like the reference's:

* ``counted``: FLOPs by dtype, bytes, ops, each kernel's charges;
* ``memory``: argument and output bytes, the live-bytes peak
  (``peak_estimate_gb``, the counterpart of ``memory_analysis``);
* ``roofline``: ``launch.roofline.roofline_terms`` at the H100's peaks,
  the reference's ``loop_factor`` beside the port's 1;
* ``model_flops_global`` and ``useful_flops_ratio`` (LM cells);
* ``sharded``: each argument's bytes per device under the single-pod
  (16 x 16) and multi-pod (2 x 16 x 16) rules
  (``distributed.sharding.spec_for`` over the cell's axes,
  ``launch.cell.cell_rules``), and whether every sharded dim divides: what
  replaces the reference's fits-proof on 256 or 512 devices;
* ``count_s`` in place of the lower and compile times.

With ``--mesh single`` or ``multi`` (``both``: each) an LM cell is
counted as the reference's record of one device of its production mesh
(16 x 16 = 256 devices, or 2 x 16 x 16 = 512): rank 0's program, built
over a ``DeviceMesh`` under ``launch.mesh.fake_world`` (DTensor
arguments at the reference's placements, ``launch.cell``), counted by
``launch.count.Counter`` as the local ops it runs. Its record holds
``n_devices``; ``memory`` with rank 0's argument and output bytes and
the peak of its live bytes; ``roofline`` with the collective bytes by
kind (``collective_breakdown``, priced at the card's link rate,
``roofline.mesh_peaks_of``);
and ``useful_flops_ratio = model_flops / (flops_per_device x
n_devices)``, as the reference's. ``--mesh none`` (the default) writes
the one-device record above, unchanged. GNN and FM cells take no mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--device meta|cuda]
  python -m repro_torch.launch.dryrun --all --mesh both [--device meta]

``--device cuda`` builds the cell on the card (inputs drawn from the seed)
and counts the step as it runs there; it raises without a card (over a
mesh: rank 0's shards, its collectives on the fake backend). Records go
to ``results/dryrun_torch/<arch>__<shape>__<device>.json``, and over a
mesh to ``<arch>__<shape>__<single|multi>__<device>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import count, roofline as rl
from repro_torch.launch.cell import build_cell, cell_rules
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import make_production_mesh

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")
CARD = "NVIDIA H100 80GB HBM3"     # the card whose peaks price the terms


def leaves_with_axes(value, axes):
    """(tensor, logical axes) pairs of a cell's argument and its axes
    tree (dicts, lists, tuples and dataclasses side by side); a tensor
    without axes is replicated (None)."""
    if isinstance(value, torch.Tensor):
        yield value, axes
    elif isinstance(value, dict):
        for k, v in value.items():
            yield from leaves_with_axes(v, None if axes is None else axes[k])
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from leaves_with_axes(v, None if axes is None else axes[i])
    elif dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            yield from leaves_with_axes(
                getattr(value, f.name),
                None if axes is None else getattr(axes, f.name))


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (of a
    DTensor, its local shard's)."""
    seen, n = set(), 0
    for t, _ in leaves_with_axes(tree, None):
        if shlib.is_dtensor(t):          # this device's shard
            t = t.to_local()
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def sharded_bytes(arch, shape_name: str, args, arg_axes,
                  multi_pod: bool) -> dict:
    """The arguments' bytes on one device of the production mesh under
    the cell's rules, and whether every sharded dim divides evenly."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = cell_rules(arch, shape_name, mesh)
    total, divisible, largest = 0, True, (0, "")
    for t, axes in leaves_with_axes(args, arg_axes):
        spec = shlib.spec_for(axes, rules, mesh) if axes is not None else ()
        shard = shlib.per_device_shape(tuple(t.shape), spec, mesh)
        n = t.element_size()
        for d in shard:
            n *= d
        total += n
        divisible &= shlib.check_divisibility(tuple(t.shape), spec, mesh)
        if n > largest[0]:
            largest = (n, f"{tuple(t.shape)} {spec}")
    return {"n_devices": mesh.size, "mesh": mesh.shape,
            "argument_bytes_per_device": total,
            "divisible": bool(divisible),
            "largest_leaf_bytes": largest[0], "largest_leaf": largest[1]}


MESHES = {"none": (None,), "single": ("single",), "multi": ("multi",),
          "both": ("single", "multi")}


def run_cell(arch_id: str, shape_name: str, device: str = "meta",
             save: bool = True, seed: int = 0,
             mesh: str | None = None) -> dict:
    """Build the cell on ``device``, count one step, return (and save)
    its record; with ``mesh`` (``"single"`` or ``"multi"``) the record of
    rank 0 of that production mesh."""
    if mesh is not None:
        return run_mesh_cell(arch_id, shape_name, mesh, device, save, seed)
    t0 = time.perf_counter()
    cell = build_cell(get_arch(arch_id), shape_name, device, seed)
    summary, out = count.count_call(
        cell["step_fn"], *cell["args"],
        counter=count.Counter(sms=rl.peaks_of(CARD).sms))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    rec = record(arch_id, shape_name, cell, summary, storage_bytes(out),
                 time.perf_counter() - t0)
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        path = RESULTS_DIR / (f"{arch_id}__{shape_name}__"
                              f"{rec['device']}.json")
        path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def run_mesh_cell(arch_id: str, shape_name: str, mesh: str,
                  device: str = "meta", save: bool = True,
                  seed: int = 0) -> dict:
    """Rank 0's program of an LM cell over the ``mesh`` (``"single"`` or
    ``"multi"``) production mesh, built on ``device`` (``meta``, or the
    card) and counted; returns (and saves) its record."""
    t0 = time.perf_counter()
    arch = get_arch(arch_id)
    if arch.family != "lm":
        raise ValueError(f"--mesh: {arch_id} is not an LM arch")
    names = make_production_mesh(multi_pod=mesh == "multi")
    dev = torch.device(device)
    with mesh_lib.fake_world(names.size):
        dmesh = mesh_lib.device_mesh(names, "cuda" if dev.type == "cuda"
                                     else "cpu")
        cell = build_cell(arch, shape_name, device, seed, mesh=dmesh)
        summary, out = count.count_call(
            cell["step_fn"], *cell["args"],
            counter=count.Counter(sms=rl.peaks_of(CARD).sms))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rec = mesh_record(arch_id, shape_name, mesh, names.size, cell,
                          summary, storage_bytes(out),
                          time.perf_counter() - t0)
        del cell, out
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        path = RESULTS_DIR / (f"{arch_id}__{shape_name}__{mesh}__"
                              f"{rec['device']}.json")
        path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def mesh_record(arch_id: str, shape_name: str, mesh: str, n_devices: int,
                cell: dict, summary: dict, out_bytes: int,
                count_s: float) -> dict:
    """The per-device record of rank 0's program over the ``mesh``
    production mesh, shaped like the reference's."""
    device = next(t for t, _ in leaves_with_axes(cell["args"], None)).device
    peaks = rl.mesh_peaks_of(CARD)
    terms = rl.roofline_terms(summary["flops_by_dtype"], summary["bytes"],
                              summary["collective_bytes"], peaks,
                              reference_factor=rl.loop_factor(arch_id,
                                                              shape_name))
    mf = rl.model_flops(arch_id, shape_name)
    rec = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh,
        "mesh_shape": cell["meta"]["mesh"],
        "device": device.type,
        "n_devices": n_devices,
        "kind": cell["kind"],
        "count_s": round(count_s, 2),
        "memory": {
            "argument_bytes_per_device": storage_bytes(cell["args"]),
            "output_bytes_per_device": out_bytes,
            "peak_live_bytes": summary["peak_live_bytes"],
            "peak_estimate_gb": round(summary["peak_live_bytes"] / 1e9, 3),
        },
        "counted": {k: summary[k] for k in (
            "flops_by_dtype", "flops", "bytes", "collective_bytes", "n_ops",
            "kernels")},
        "roofline": terms,
        "model_flops_global": mf,
        "meta": cell.get("meta", {}),
    }
    if mf is not None and terms["flops_per_device"] > 0:
        rec["useful_flops_ratio"] = round(
            mf / (terms["flops_per_device"] * n_devices), 4)
    return rec


def record(arch_id: str, shape_name: str, cell: dict, summary: dict,
           out_bytes: int, count_s: float) -> dict:
    """The record of ``cell`` (built by ``launch.cell``) whose step
    ``launch.count`` counted as ``summary``."""
    arch = get_arch(arch_id)
    device = next(t for t, _ in leaves_with_axes(cell["args"], None)).device
    peaks = rl.peaks_of(CARD)
    terms = rl.roofline_terms(summary["flops_by_dtype"], summary["bytes"],
                              {}, peaks,
                              reference_factor=rl.loop_factor(arch_id,
                                                              shape_name))
    mf = rl.model_flops(arch_id, shape_name)
    arg_bytes = storage_bytes(cell["args"])
    rec = {
        "arch": arch_id,
        "shape": shape_name,
        "device": device.type,
        "n_devices": 1,
        "kind": cell["kind"],
        "count_s": round(count_s, 2),
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "peak_live_bytes": summary["peak_live_bytes"],
            "peak_estimate_gb": round(summary["peak_live_bytes"] / 1e9, 3),
        },
        "counted": {k: summary[k] for k in ("flops_by_dtype", "flops",
                                            "bytes", "n_ops", "kernels")},
        "roofline": terms,
        "model_flops_global": mf,
        "sharded": {
            name: sharded_bytes(arch, shape_name, cell["args"],
                                cell["arg_axes"], multi)
            for name, multi in (("single", False), ("multi", True))},
        "meta": cell.get("meta", {}),
    }
    if mf is not None and terms["flops_per_device"] > 0:
        rec["useful_flops_ratio"] = round(mf / terms["flops_per_device"], 4)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="meta",
                    help="meta (shapes only, the default) or cuda")
    ap.add_argument("--mesh", default="none", choices=sorted(MESHES),
                    help="none (one device, the default), single (16 x 16), "
                    "multi (2 x 16 x 16) or both; LM archs only")
    args = ap.parse_args()

    archs = list(ARCHS) if args.all or args.arch is None else [args.arch]
    meshes = MESHES[args.mesh]
    if args.mesh != "none":
        archs = [a for a in archs if get_arch(a).family == "lm"]
    failures = []
    t_all = time.perf_counter()
    for arch_id in archs:
        arch = get_arch(arch_id)
        shapes = [args.shape] if args.shape else list(arch.shapes)
        for shape, mesh in ((s, m) for s in shapes for m in meshes):
            tag = f"{arch_id} x {shape}" + (f" x {mesh}" if mesh else "")
            try:
                rec = run_cell(arch_id, shape, args.device, mesh=mesh)
                if mesh is not None:
                    r, m = rec["roofline"], rec["memory"]
                    print(f"OK   {tag:50s} count={rec['count_s']:6.1f}s "
                          f"peak={m['peak_estimate_gb']:8.3f}GB "
                          f"args={m['argument_bytes_per_device'] / 1e9:.3f}"
                          f"GB flops={r['flops_per_device']:.4g} "
                          f"bytes={r['bytes_per_device']:.4g} "
                          f"coll={r['collective_bytes_per_device']:.4g} "
                          f"dom={r['dominant']:10s} "
                          f"bound={r['bound_s'] * 1e3:.3f}ms", flush=True)
                    continue
                r, sh = rec["roofline"], rec["sharded"]
                print(f"OK   {tag:40s} count={rec['count_s']:6.1f}s "
                      f"peak={rec['memory']['peak_estimate_gb']:9.3f}GB "
                      f"flops={r['flops_per_device']:.4g} "
                      f"bytes={r['bytes_per_device']:.4g} "
                      f"dom={r['dominant']:8s} "
                      f"frac={r['roofline_fraction']:.3f} "
                      f"bound={r['bound_s'] * 1e3:.3f}ms "
                      "args a device: single "
                      f"{sh['single']['argument_bytes_per_device'] / 1e9:.3f}"
                      "GB, multi "
                      f"{sh['multi']['argument_bytes_per_device'] / 1e9:.3f}"
                      "GB", flush=True)
            # greenlint: broad-except — a cell's failure is reported and
            # the matrix goes on; main exits non-zero at the end
            except Exception as e:  # noqa: BLE001
                failures.append(tag)
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("all cells passed")


if __name__ == "__main__":
    main()
