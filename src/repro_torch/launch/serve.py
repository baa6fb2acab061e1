"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Port of ``repro/launch/serve.py``: the prompt goes through the KV cache
token by token (``decode_step``), then the batch decodes greedily. ``main``
runs the arch's smoke config, as the reference does; :func:`run` takes any
config, so the full-width model is ``run(arch.make_config(), ...)``.
``--device`` defaults to the card and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.device import resolve


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen_len) greedy tokens
    prompt_logits: torch.Tensor   # (B, V) logits after the last prompt token
    decode_s: float               # wall time of the gen_len - 1 decode steps


def run(cfg, *, batch: int, prompt_len: int, gen_len: int, device="cuda",
        seed: int = 0, prompts=None, params=None) -> ServeResult:
    """Feed ``prompts`` (B, prompt_len) token by token, then decode
    ``gen_len`` tokens greedily. Without ``params`` the model is drawn
    from ``seed``; without ``prompts`` they are drawn from ``seed + 1``."""
    from repro_torch.models.lm import transformer as tf

    dev = resolve(device)
    if params is None:
        params = tf.init(cfg, seed=seed, device=dev)
    if prompts is None:
        gen = torch.Generator().manual_seed(seed + 1)
        prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                generator=gen)
    prompts = torch.as_tensor(prompts).to(dev)
    cache = tf.init_cache(cfg, batch, prompt_len + gen_len, device=dev)
    logits = None
    for i in range(prompt_len):
        logits, cache = tf.decode_step(params, cfg, prompts[:, i:i + 1],
                                       cache, i)
    prompt_logits = logits
    tokens = logits.argmax(dim=-1)[:, None]
    out = [tokens]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for s in range(gen_len - 1):
        logits, cache = tf.decode_step(params, cfg, tokens, cache,
                                       prompt_len + s)
        tokens = logits.argmax(dim=-1)[:, None]
        out.append(tokens)
    gen_tokens = torch.cat(out, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ServeResult(gen_tokens, prompt_logits, time.perf_counter() - t0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs.registry import get_arch

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("serve.py drives LM archs")
    res = run(arch.make_smoke_config(), batch=args.batch,
              prompt_len=args.prompt_len, gen_len=args.gen_len,
              device=args.device)
    dt = res.decode_s
    print(f"decoded {args.gen_len} x {args.batch} in {dt:.2f}s "
          f"({args.batch * args.gen_len / max(dt, 1e-9):.0f} tok/s)")
    print("first sequence:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
