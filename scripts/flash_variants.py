#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel against the design variants it
was chosen over, on one CUDA card.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/flash_variants.py

Each variant is the committed ``src/repro_torch/kernels/csrc/flash_attention.cu``
with one textual change, compiled by ``nvcc`` (all at once) into
``build/flash_variants/`` and loaded with ``ctypes``:

- ``committed``: 128 x 64 tiles, ``ex2.approx`` exponentials, two CTAs
  per SM at D <= 64;
- ``exp2f``: the exponentials through ``exp2f`` (the accurate library
  routine) instead of ``ex2.approx``;
- ``bk128``: 128-key tiles (``m64n128k16`` for Q . K^T), one CTA per SM;
- ``bk128_exp2f``: both changes, the kernel's first design.

Every variant is held against the plain version at its own tiles (atol
1e-3, rtol 1e-2) at TinyLlama's prefill shape (B=2, S=4096, Hq=32,
Hkv=4, D=64, bf16, causal), then timed there with CUDA events (median of
25 launches, L2 flushed before each), in the order A B C D D C B A, beside
``F.scaled_dot_product_attention`` as a yardstick. It prints the card's
name and power limit first. Exits non-zero without a card or if a
variant fails to build or disagrees.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_variants"
B, S, HQ, HKV, D = 2, 4096, 32, 4, 64


def _wgmma_ss_n128() -> str:
    """The m64n128k16 shared-memory wgmma that 128-key tiles need."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return (
        "__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,"
        " uint64_t b, int scale_d) {\n  asm volatile(\n"
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
        f'      "{{{regs}}}, %64, %65, p, 1, 1, 0, 0;\\n}}\\n"\n'
        f'      : {outs}\n      : "l"(a), "l"(b), "r"(scale_d));\n}}\n\n')


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"flash_variants: the source no longer has {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, tuple[str, int]]:
    """{name: (source text, keys per tile)}"""
    def exp2f(t):
        t = _replace(t, "? ex2((m[i] - m_new)", "? exp2f((m[i] - m_new)")
        return _replace(t, "? ex2(fmaf(", "? exp2f(fmaf(")

    def bk128(t):
        t = _replace(t, "static constexpr int BK = 64;",
                     "static constexpr int BK = 128;")
        t = _replace(t, "__launch_bounds__(THREADS, D <= 64 ? 2 : 1)",
                     "__launch_bounds__(THREADS, 1)")
        return _replace(t, "// d (+)= A . B, m64n64k16",
                        _wgmma_ss_n128() + "// d (+)= A . B, m64n64k16")

    return {"committed": (src, 64), "exp2f": (exp2f(src), 64),
            "bk128": (bk128(src), 128),
            "bk128_exp2f": (bk128(exp2f(src)), 128)}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_variants: needs a CUDA card", file=sys.stderr)
        return 3
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_plain

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, (text, bk) in variants(SOURCE.read_text()).items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = (bk, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (bk, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            print(f"flash_variants: {name} failed to build", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).flash_attention_fwd
        fn.argtypes = _build.ENTRIES["flash_attention_fwd"][1]
        fn.restype = ctypes.c_int
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"{name}: built, registers per instance {regs}")
        fns[name] = (fn, bk)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((B, S, h, D), generator=gen).to(dev, torch.bfloat16)
               for h in (HQ, HKV, HKV))

    def launch(fn, o):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, D,
                 B, S, S, HQ, HKV, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *o.stride()[:3], 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    for name, (fn, bk) in fns.items():
        o = torch.empty_like(q)
        launch(fn, o)
        want = flash_attention_plain(q, k, v, True, 128, bk).float()
        err = float((o.float() - want).abs().max())
        print(f"{name}: max|kernel-plain at 128x{bk}| = {err:.3e}")
        if not torch.allclose(o.float(), want, atol=1e-3, rtol=1e-2):
            print(f"flash_variants: {name} disagrees", file=sys.stderr)
            return 1
        del want

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def ms(fn, repeats=25):
        for _ in range(3):
            fn()
        samples = []
        for _ in range(repeats):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            samples.append(a.elapsed_time(b))
        return statistics.median(samples)

    flops = 4.0 * B * HQ * D * (S * (S + 1) / 2)
    times = {name: [] for name in fns}
    o = torch.empty_like(q)
    for name in list(fns) + list(reversed(list(fns))):
        times[name].append(ms(lambda: launch(fns[name][0], o)))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    for name, ts in times.items():
        print(f"{name}: {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"({flops / statistics.mean(ts) / 1e9:.1f} TFLOP/s)")
    print(f"F.scaled_dot_product_attention: {sdpa:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
