#!/usr/bin/env python3
"""Time the trainer's CSR SpMM at its three path shapes, under three cache
conditions, against the batching it was chosen over and
``torch.sparse.mm``, on one CUDA card.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/spmm_timing.py

The operands are ``chip_smoke.py``'s: the CSR of the main path's first
mini-batch (layer 0: X (8192, 64); layer 1: X (2048, 16); layer 1's
transpose, dY (256, 16)). The CSR kernel comes in two builds of ``src/repro_torch/kernels/csrc/csr_spmm.cu``,
compiled by ``nvcc`` (at once) into ``build/spmm_timing/`` and loaded
with ``ctypes``:

- ``committed``: batches of max(G, 16) entries, 16 X gathers in flight
  per lane (8 at G = 32), the next batch's entries loaded early;
- ``first``: batches of G entries and min(G, 8) gathers in flight, the
  batching of the kernel's first build (4 entries a batch at F = 16).

Each call is timed five ways:

- ``zero-flushed``: ``chip_smoke.py``'s timing row: a 64 MB buffer zeroed
  before each launch, a spin kernel (``torch.cuda._sleep``) queued behind
  it, then CUDA events around the call, median of 25. The spin keeps the
  device busy while the host enqueues the events and the call, so the
  events time the device. The zeroing leaves the L2 full of dirty lines
  that the launch's misses write back;
- ``unqueued``: the same without the spin, as ``chip_smoke.py`` timed
  before: when the host enqueues the call more slowly than the device
  runs the flush, the events count the host's enqueue time too;
- ``read-flushed``: as ``zero-flushed`` with the buffer summed instead,
  so the L2 holds other, clean data;
- ``kernel, zero-flushed``: the device time of the call's own kernels in
  the zero-flushed loop, from ``torch.profiler`` (launch latency and the
  events' own cost left out);
- ``kernel, warm``: the same over 50 calls back to back, the inputs in
  L2 as the trainer leaves them.

The floor is the committed kernel on a one-row matrix with no entries.
Every build is first held against the plain version (``TOL_SPMM``), and
the two builds bit-equal to each other (both sum a row's entries in
ascending column order). The kernels run in the order committed, first,
library, first, committed. It prints the card's name and power limit first and exits
non-zero without a card or if a build fails or disagrees.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "csr_spmm.cu"
OUT = ROOT / "build" / "spmm_timing"
REPEATS = 25
WARM_CALLS = 50


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"spmm_timing: the source no longer has {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    first = _replace(src, "constexpr int B = G < 16 ? 16 : G;",
                     "constexpr int B = G;")
    first = _replace(first, "constexpr int U = G < 32 ? 16 : 8;",
                     "constexpr int U = G < 8 ? G : 8;")
    return {"committed": src, "first": first}


def build() -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in variants(SOURCE.read_text()).items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            raise SystemExit(f"spmm_timing: {name} failed to build")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).csr_spmm_f32
        fn.argtypes = _build.ENTRIES["csr_spmm_f32"][1]
        fn.restype = ctypes.c_int
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: built, registers per instance {regs}, spills "
              f"{spills or 'none'}")
        fns[name] = fn
    return fns


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("spmm_timing: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke
    from repro_torch.kernels.segment_mm import CsrFormat
    from repro_torch.kernels.segment_mm import ops as spmm_ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fns = build()
    ops = chip_smoke.main_path_operands(torch, dev)
    cases = chip_smoke.spmm_cases(ops)
    stream = torch.cuda.current_stream().cuda_stream

    def csr_call(fn, fmt, x, y):
        # the float4 instance: every operand here is contiguous, F % 4 == 0
        err = fn(fmt.rowptr.data_ptr(), fmt.col.data_ptr(), fmt.val.data_ptr(),
                 x.data_ptr(), y.data_ptr(), fmt.n_rows, x.shape[1],
                 x.stride(0), y.stride(0), 1, stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def spin():
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)

    # {condition: (flush, spin before the start event)}
    events = {"zero-flushed": (flush.zero_, spin),
              "unqueued": (flush.zero_, lambda: None),
              "read-flushed": (lambda: flush.sum(), spin)}

    def own_kernels_ms(prof, n_calls, skip) -> float:
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.name not in skip)
        return us / 1e3 / n_calls

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(3):
            flush.zero_()
            spin()
        torch.cuda.synchronize()
    zero_names = {e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA}

    def measure(call) -> dict:
        for _ in range(3):
            call()
        out = {}
        for kind, (flush_fn, wait) in events.items():
            samples = []
            for _ in range(REPEATS):
                flush_fn()
                wait()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                samples.append(a.elapsed_time(b))
            out[kind] = statistics.median(samples)
        with profile(activities=acts) as prof:
            for _ in range(REPEATS):
                flush.zero_()
                spin()
                call()
            torch.cuda.synchronize()
        out["kernel, zero-flushed"] = own_kernels_ms(prof, REPEATS,
                                                     zero_names)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(WARM_CALLS):
                call()
            torch.cuda.synchronize()
        out["kernel, warm"] = own_kernels_ms(prof, WARM_CALLS, set())
        return out

    for label, fmt, x in cases:
        y = torch.empty((fmt.n_rows, x.shape[1]), device=dev)
        want = spmm_ops.csr_spmm_plain(fmt.rowptr, fmt.col, fmt.val, x)
        outs = {}
        for name, fn in fns.items():
            csr_call(fn, fmt, x, y)
            torch.cuda.synchronize()
            outs[name] = y.clone()
            if not torch.allclose(y, want, **chip_smoke.TOL_SPMM):
                print(f"spmm_timing: {name} {label} disagrees with the plain "
                      "version", file=sys.stderr)
                return 1
        if not torch.equal(outs["committed"], outs["first"]):
            print(f"spmm_timing: the two builds differ at {label}",
                  file=sys.stderr)
            return 1
        lib = torch.sparse_csr_tensor(fmt.rowptr, fmt.col, fmt.val,
                                      (fmt.n_rows, x.shape[0]),
                                      check_invariants=True)
        calls = {
            "committed": lambda: csr_call(fns["committed"], fmt, x, y),
            "first": lambda: csr_call(fns["first"], fmt, x, y),
            "torch.sparse.mm": lambda: torch.sparse.mm(lib, x),
        }
        times = {name: [] for name in calls}
        for name in ("committed", "first", "torch.sparse.mm", "first",
                     "committed"):
            times[name].append(measure(calls[name]))
        longest = int((fmt.rowptr[1:] - fmt.rowptr[:-1]).max())
        print(f"{label}: rows {fmt.n_rows}, nnz {fmt.col.numel()}, longest "
              f"row {longest}, x {tuple(x.shape)}")
        for name, runs in times.items():
            cells = ", ".join(
                f"{k} " + " / ".join(f"{r[k]:.4f}" for r in runs)
                for k in runs[0])
            print(f"  {name:16s} ms: {cells}")

    empty = CsrFormat.from_numpy([0, 0], [], [], 1, dev)
    x1 = torch.zeros((1, 64), device=dev)
    y1 = torch.empty((1, 64), device=dev)
    floor = measure(lambda: csr_call(fns["committed"], empty, x1, y1))
    print("floor (one empty row) ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in floor.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
