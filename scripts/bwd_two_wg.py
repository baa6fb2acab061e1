#!/usr/bin/env python3
"""Time the bf16 flash backward's two-warpgroup kernels where the
committed build runs the one-warpgroup ones, on one CUDA card.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/bwd_two_wg.py

The committed ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
takes two warpgroups only at D = 192 (``Cfg::TWO_WG``). The variant is
the same source with the two-warpgroup dK/dV kernel
(``bwd_dkdv_wgmma2_kernel``) at D = 64 and 128 too, and the
two-warpgroup dQ kernel (``bwd_dq_wgmma2_kernel``) at D = 128 (it needs
two 64-column atoms, so D = 64 keeps the one-warpgroup dQ), compiled by
``nvcc`` into ``build/bwd_two_wg/`` and loaded with ``ctypes`` in place
of the committed library. At TinyLlama's training shape (B=1, S=4096,
Hq=32, Hkv=4, D=64, causal; dK/dV in ``dkdv_split``'s parts) and
moonshot's (Hq=Hkv=16, D=128) each build's dQ, dK and dV are held
against the plain version (``chip_smoke``'s bf16 backward tolerance),
then both are timed with CUDA events (``chip_smoke.Timer``: median of
25 calls, L2 flushed, behind a spin) in the order committed, variant,
variant, committed. It prints ptxas's registers and spills for the
variant's two-warpgroup instances, and the card's name and power limit
first. Exits non-zero without a card, if the variant does not build or
if either build disagrees.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "bwd_two_wg"
SHAPES = (("tinyllama (64, 64)", 32, 4, 64), ("moonshot (128, 128)", 16, 16,
                                               128))
B, S = 1, 4096


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"bwd_two_wg: the source no longer has {old!r}")
    return text.replace(old, new)


def variant(src: str) -> str:
    t = _replace(src, "static constexpr bool TWO_WG = DQK > 128;",
                 "static constexpr bool TWO_WG = DQK > 128 || DQK == 64 "
                 "|| DQK == 128;\n  static constexpr bool TWO_WG_DQ = "
                 "DQK > 128 || DQK == 128;")
    t = _replace(t, "if constexpr (C::TWO_WG) return bwd_dq_wgmma2_kernel",
                 "if constexpr (C::TWO_WG_DQ) return bwd_dq_wgmma2_kernel")
    t = _replace(t, "const int dq_smem = C::TWO_WG ? C::DQ2_SMEM",
                 "const int dq_smem = C::TWO_WG_DQ ? C::DQ2_SMEM")
    return _replace(t, "dqk<<<q_grid, threads, dq_smem, stream>>>(",
                    "dqk<<<q_grid, C::TWO_WG_DQ ? 2 * THREADS : THREADS, "
                    "dq_smem, stream>>>(")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bwd_two_wg: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "flash_attention_bwd.cu"
    cu.write_text(variant((CSRC / "flash_attention_bwd.cu").read_text()))
    lib_path = OUT / "libflash_attention_bwd.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-o",
         str(lib_path), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr)
        print("bwd_two_wg: the variant failed to build", file=sys.stderr)
        return 1
    for name, info in cs.ptxas_functions(proc.stdout + proc.stderr).items():
        if "wgmma2" in name:
            print(f"variant ptxas {name}: {info}", flush=True)
    _build.build_all()
    committed = _build._libs.get("flash_attention_bwd") or ctypes.CDLL(
        str(_build._lib_path("flash_attention_bwd")))
    builds = {"committed": committed, "variant": ctypes.CDLL(str(lib_path))}

    device = torch.device("cuda", 0)
    timer = cs.Timer(torch, device)
    gen = torch.Generator().manual_seed(cs.SEED)
    ok = True
    for label, hq, hkv, d in SHAPES:
        q, k, v, do = (
            (torch.randn((B, S, h, d), generator=gen) * 0.5).to(
                device, torch.bfloat16) for h in (hq, hkv, hkv, hq))
        o = torch.empty_like(q)
        lse = torch.empty((B, hq, S), dtype=torch.float32, device=device)
        flash_ops.launch(q, k, v, o, True, lse=lse)
        want = flash_ops.flash_attention_bwd_plain(q, k, v, o, do, True,
                                                   lse=lse)
        grads = {}
        for who, lib in builds.items():
            _build._libs["flash_attention_bwd"] = lib
            got = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
            flash_ops.launch_bwd(q, k, v, o, do, lse, *got, True)
            torch.cuda.synchronize()
            grads[who] = got
            for nm, g, w in zip(("dq", "dk", "dv"), got, want):
                g, w = g.float(), w.float()
                err = float((g - w).abs().max())
                atol = cs.TOL_BWD_BF16_ATOL_FRAC * float(w.abs().max())
                good = bool(torch.allclose(g, w, rtol=cs.TOL_BWD_BF16_RTOL,
                                           atol=atol))
                ok &= good
                print(f"{label} {who} {nm}: max|kernel-plain| {err:.3e}"
                      + ("" if good else " DISAGREES"), flush=True)
        same = all(torch.equal(a, b) for a, b in zip(grads["committed"],
                                                     grads["variant"]))
        print(f"{label}: the builds' gradients bit-equal: {same}",
              flush=True)
        dq, dk, dv = grads["committed"]
        times = {w: [] for w in builds}
        for who in ("committed", "variant", "variant", "committed"):
            _build._libs["flash_attention_bwd"] = builds[who]
            times[who].append(timer.ms(lambda: flash_ops.launch_bwd(
                q, k, v, o, do, lse, dq, dk, dv, True)))
        _build._libs["flash_attention_bwd"] = builds["committed"]
        ms = {w: statistics.median(t) for w, t in times.items()}
        print(f"time {label} B={B} S={S} Hq={hq} Hkv={hkv} bf16 causal, "
              f"dK/dV in {flash_ops.dkdv_split(q, k)} parts: committed "
              f"{ms['committed']:.4f} ms {times['committed']}, two "
              f"warpgroups {ms['variant']:.4f} ms {times['variant']}, "
              f"ratio {ms['variant'] / ms['committed']:.3f}; "
              f"{cs.smi_line()}", flush=True)
        del q, k, v, do, o, want, grads
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
