#!/usr/bin/env python3
"""Time the EmbeddingBag kernel at the trainer's gather shapes against a
bulk-copy variant, an optional earlier build and ``F.embedding_bag``, on
one CUDA card.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/bag_timing.py [--baseline OTHER/embedding_bag.cu]

Builds, compiled by ``nvcc`` (at once) into ``build/bag_timing/`` and
loaded with ``ctypes``, all with the C entry ``embedding_bag_f32``:

- ``committed``: ``src/repro_torch/kernels/csrc/embedding_bag.cu``;
- ``bulk``: the rows through shared memory by Hopper's bulk-copy engine
  (``cp.async.bulk`` of a whole row, completion on an ``mbarrier``), up
  to 8 rows of a bag in flight, then summed from shared memory in the
  same order (its source is below; D % 4 == 0 and D <= 128 only);
- ``baseline``: another source with the C entry, for example an earlier
  commit's kernel unpacked by ``git archive`` (an entry without the
  ``n_lookups`` and ``max_len`` arguments is called without them).

The operands are ``chip_smoke.py``'s: the gather at the padded shape the
device tier ran until it dropped the pad (L = 8192, pad bags weight 0),
at the path's own shape (one bag per hit) and weighted bags with 512
empty ones. Every build is first held bit-equal to ``table[idx]`` on the
gathers and to the committed kernel on the weighted bags. Each call is
timed three ways, as ``scripts/spmm_timing.py`` does: CUDA events with
the L2 zeroed and a spin queued before each call (median of 25), and the
call's own kernel time from ``torch.profiler``, L2 flushed and warm. The
builds run in the order committed, bulk, baseline, library, baseline,
bulk, committed. The floor is the committed kernel on one empty bag. It
prints the card's name and power limit first and exits non-zero without
a card or if a build disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "embedding_bag.cu"
OUT = ROOT / "build" / "bag_timing"

BULK = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 8;  // rows of a bag in flight, in shared memory

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int G>
__global__ void __launch_bounds__(THREADS)
bag_bulk_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const int* __restrict__ offsets,
                const float* __restrict__ table, float* __restrict__ out,
                int n_bags, int d) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ __align__(8) uint64_t bars[THREADS / G];
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane - sub);
  const int local = threadIdx.x / G;
  const int bag = blockIdx.x * (THREADS / G) + local;
  if (bag >= n_bags) return;
  const int q = d / 4;
  float4* rows = ring + (size_t)local * R * q;
  const uint32_t bar = smem(&bars[local]);
  if (sub == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp(mask);
  const int begin = __ldg(offsets + bag), end = __ldg(offsets + bag + 1);
  const bool active = sub < q;
  float4 acc = make_float4(-0.f, -0.f, -0.f, -0.f);
  uint32_t phase = 0;
  for (int e0 = begin; e0 < end; e0 += R) {
    const int n = min(R, end - e0);
    if (sub == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(n * d * 4) : "memory");
      for (int k = 0; k < n; ++k) {
        const float* src = table + (size_t)__ldg(idx + e0 + k) * d;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(smem(rows + k * q)), "l"(src), "r"(d * 4), "r"(bar)
            : "memory");
      }
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    }
    phase ^= 1;
    if (active) {
      for (int k = 0; k < n; ++k) {
        const float wk = __ldg(w + e0 + k);
        const float4 x = rows[k * q + sub];
        acc = make_float4(__fadd_rn(acc.x, __fmul_rn(wk, x.x)),
                          __fadd_rn(acc.y, __fmul_rn(wk, x.y)),
                          __fadd_rn(acc.z, __fmul_rn(wk, x.z)),
                          __fadd_rn(acc.w, __fmul_rn(wk, x.w)));
      }
    }
    __syncwarp(mask);  // the batch is read before the next one lands
  }
  if (active) {
    __stcs(reinterpret_cast<float4*>(out + (size_t)bag * d) + sub,
           end > begin ? acc : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

template <int G>
void launch(const int* idx, const float* w, const int* offsets,
            const float* table, float* out, int n_bags, int d,
            cudaStream_t s) {
  const int grid = (n_bags + THREADS / G - 1) / (THREADS / G);
  const size_t ring = (size_t)(THREADS / G) * R * (d / 4) * sizeof(float4);
  bag_bulk_kernel<G><<<grid, THREADS, ring, s>>>(idx, w, offsets, table,
                                                 out, n_bags, d);
}

}  // namespace

extern "C" int embedding_bag_f32(const void* idx, const void* w,
                                 const void* offsets, const void* table,
                                 void* out, int n_bags, int d, int n_lookups,
                                 int max_len, void* stream) {
  if (d <= 0 || d > 128 || d % 4 != 0
      || reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_bags > 0) {
    const auto* ix = static_cast<const int*>(idx);
    const auto* wt = static_cast<const float*>(w);
    const auto* of = static_cast<const int*>(offsets);
    const auto* tb = static_cast<const float*>(table);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const int q = d / 4;
    if (q <= 4) launch<4>(ix, wt, of, tb, o, n_bags, d, s);
    else if (q <= 8) launch<8>(ix, wt, of, tb, o, n_bags, d, s);
    else if (q <= 16) launch<16>(ix, wt, of, tb, o, n_bags, d, s);
    else launch<32>(ix, wt, of, tb, o, n_bags, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build(baseline: str | None) -> dict:
    """{name: ctypes entry} for every source that builds. The committed
    source must build; a variant that does not is reported and left
    out."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"committed": SOURCE.read_text(), "bulk": BULK}
    if baseline:
        sources["baseline"] = pathlib.Path(baseline).read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
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
            print(f"{name}: build failed\n{log}")
            if name == "committed":
                raise SystemExit("bag_timing: the committed kernel failed")
            continue
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).embedding_bag_f32
        argtypes = list(_build.ENTRIES["embedding_bag_f32"][1])
        if "max_len" not in sources[name]:
            del argtypes[7:9]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fn.takes_lengths = len(argtypes) == 10
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="another embedding_bag.cu with "
                        "the same C entry, timed as 'baseline'")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bag_timing: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke
    from repro_torch.kernels.embedding_bag import BagFormat

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    fns = build(args.baseline)
    ops = chip_smoke.main_path_operands(torch, dev)
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 1)
    table = torch.randn((ops["capacity"], ops["n_feat"]),
                        generator=gen).to(dev)
    n = min(ops["n_remote"], 8192)
    L = 1 << (n - 1).bit_length()
    idx = torch.randint(0, ops["capacity"], (L,), generator=gen,
                        dtype=torch.int32)
    seg_r = torch.randint(0, 4096 - 512, (L,), generator=gen,
                          dtype=torch.int32)
    w_r = torch.randn(L, generator=gen)
    w_pad = torch.zeros(L)
    w_pad[:n] = 1.0
    arange = torch.arange(L, dtype=torch.int32)
    cases = {
        "padded": BagFormat.from_numpy(idx.numpy(), arange.numpy(), L,
                                       w_pad.numpy(), dev),
        "path": BagFormat.from_numpy(idx[:n].numpy(), arange[:n].numpy(), n,
                                     None, dev),
        "weighted": BagFormat.from_numpy(idx.numpy(), seg_r.numpy(), 4096,
                                         w_r.numpy(), dev),
    }
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, fmt, out):
        sizes = (fmt.n_bags, table.shape[1]) + (
            (fmt.idx.numel(), fmt.max_len) if fn.takes_lengths else ())
        err = fn(fmt.idx.data_ptr(), fmt.w.data_ptr(), fmt.offsets.data_ptr(),
                 table.data_ptr(), out.data_ptr(), *sizes, stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    timer = chip_smoke.Timer(torch, dev)

    def measure(fn) -> dict:
        # every build's kernel and F.embedding_bag's have "bag" in their
        # names; a reading whose traces lacked them is None
        flushed, warm = timer.kernel_ms(fn, r"(?i)bag")
        return {"events": timer.ms(fn), "kernel, flushed": flushed,
                "kernel, warm": warm}

    want_rows = table[idx.to(dev).long()]
    for label, fmt in cases.items():
        out = torch.empty((fmt.n_bags, table.shape[1]), device=dev)
        ref = torch.empty_like(out)
        call(fns["committed"], fmt, ref)
        torch.cuda.synchronize()
        for name, fn in fns.items():
            out.fill_(float("nan"))
            call(fn, fmt, out)
            torch.cuda.synchronize()
            ok = torch.equal(out, ref)
            if label == "path":
                ok = ok and torch.equal(out, want_rows[:n])
            if not ok:
                print(f"bag_timing: {name} {label} disagrees with the "
                      "committed kernel or table[idx]", file=sys.stderr)
                return 1
        calls = {name: (lambda fn=fn: call(fn, fmt, out))
                 for name, fn in fns.items()}
        calls["F.embedding_bag"] = lambda: F.embedding_bag(
            fmt.idx, table, fmt.offsets[:-1], mode="sum",
            per_sample_weights=fmt.w)
        order = ["committed", "bulk", "baseline", "F.embedding_bag",
                 "baseline", "bulk", "committed"]
        times = {name: [] for name in calls}
        for name in order:
            if name in calls:
                times[name].append(measure(calls[name]))
        print(f"{label}: lookups {fmt.idx.numel()}, bags {fmt.n_bags}, "
              f"table {tuple(table.shape)}")
        for name, runs in times.items():
            cells = ", ".join(
                f"{k} " + " / ".join(_ms(r[k]) for r in runs)
                for k in runs[0])
            print(f"  {name:16s} ms: {cells}")

    empty = BagFormat.from_numpy([], [], 1, None, dev)
    one = torch.empty((1, table.shape[1]), device=dev)
    floor = measure(lambda: call(fns["committed"], empty, one))
    print("floor (one empty bag) ms: " + ", ".join(
        f"{k} {_ms(v)}" for k, v in floor.items()))
    return 0


def _ms(v) -> str:
    return "none" if v is None else f"{v:.4f}"


if __name__ == "__main__":
    sys.exit(main())
