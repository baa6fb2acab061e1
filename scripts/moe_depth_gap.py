#!/usr/bin/env python3
"""Read how far two paths of the MoE archs' random-weight models drift
apart with depth, in bf16 and in float32, on one CUDA card.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/moe_depth_gap.py

``chip_smoke.compare_paths`` (logged, not held) on views of one model's
first L layers: decode steps against a no-drop prefill of the prompts,
the routing replayed (MLA: the absorbed decode against the expanded
prefill), and the S=4,096 prefill of one sequence through the flash
kernel against the dense path, the routing replayed. Its inputs are
``chip_smoke``'s serving inputs and its parameters are drawn from
``chip_smoke.SEED``:

- moonshot-v1-16b-a3b in bf16 at L = 4, 8, 16 and 48 (full depth), and
  in float32 at L = 4 and 12 (what fits the card in float32);
- deepseek-v2-236b in bf16 at L = 2, 4, 6 and 9 (its served depth),
  decode against prefill only (the dense path's 128 heads of scores do
  not fit beside 9 layers), and in float32 at L = 3, both comparisons.

At the deepest bf16 view of each arch ``serve.run`` runs first, and its
logits are held equal to the same decode steps' on their own routing
(as ``chip_smoke`` holds them). Float32 rules bf16 rounding in or out:
if the float32 paths agree to ~1e-4 where the bf16 ones are 0.1-0.5
apart, the bf16 gap is rounding. The last line is one JSON object of
every reading; the card's name and power limit come first. Exits
non-zero without a card.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (arch, dtype, views' depths, the deepest view also through serve.run,
#  the flash-against-dense comparison too)
SWEEPS = (
    ("moonshot-v1-16b-a3b", "bfloat16", (4, 8, 16, 48), True, True),
    ("moonshot-v1-16b-a3b", "float32", (4, 12), False, True),
    ("deepseek-v2-236b", "bfloat16", (2, 4, 6, 9), True, False),
    ("deepseek-v2-236b", "float32", (3,), False, True),
)


def sweep(torch, device, cs, arch, dtype, depths, serve_too, dense):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.lm import transformer as tf

    cfg = dataclasses.replace(get_arch(arch).make_config(),
                              n_layers=max(depths), dtype=dtype)
    params = tf.init(cfg, seed=cs.SEED, device=device)
    prompts, tokens = cs.serve_inputs(torch, cfg, device)
    serve_logits = None
    if serve_too:
        serve_logits = serve.run(
            cfg, batch=4, prompt_len=cs.SERVE_PROMPT, gen_len=cs.SERVE_GEN,
            device=device, prompts=prompts, params=params).prompt_logits
    out = {}
    for depth in depths:
        cut = dataclasses.replace(cfg, n_layers=depth)
        view = dict(params, layers={k: t[:cut.n_scan_layers]
                                    for k, t in params["layers"].items()})
        out[depth] = cs.compare_paths(
            torch, device, cut, view, prompts, tokens, arch,
            serve_logits if depth == cfg.n_layers else None, None,
            bound=None, dense=dense)
    del params, view, tokens
    torch.cuda.empty_cache()
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("moe_depth_gap: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(cs.smi_line(), flush=True)
    _build.build_all()
    readings = {}
    for arch, dtype, depths, serve_too, dense in SWEEPS:
        t0 = time.perf_counter()
        readings[f"{arch} {dtype}"] = sweep(torch, device, cs, arch, dtype,
                                            depths, serve_too, dense)
        print(f"{arch} {dtype}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
