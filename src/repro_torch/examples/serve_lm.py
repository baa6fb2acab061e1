"""Serve a small LM with batched requests: prefill + KV-cache decode.

Uses the qwen3-family smoke config (GQA + qk-norm) with greedy decoding over
a batch of prompts, the serving path the decode_32k / long_500k dry-run
cells exercise at production scale:

    python -m repro_torch.examples.serve_lm [--device cuda] [--seed 0]

Port of ``examples/serve_lm.py``: the prompt goes through the cache by
one ``decode_step`` a token, then the batch decodes greedily. The weights
come from ``--seed`` through ``transformer.init``, the prompts from a
generator seeded with ``seed + 1``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve
from repro_torch.models.lm import transformer as tf

ARCH = "qwen3-1.7b"
BATCH, PROMPT_LEN, GEN_LEN, MAX_LEN = 4, 12, 20, 40


@dataclasses.dataclass
class Generated:
    ids: torch.Tensor         # (B, gen_len) greedy tokens
    logits: torch.Tensor      # (B, gen_len, V): the logits each token was
                              # chosen from
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, cfg, prompts, gen_len: int, max_len: int,
             device) -> Generated:
    """Prefill ``prompts`` (B, P) token by token into a ``max_len`` cache,
    then decode ``gen_len`` tokens greedily."""
    dev = resolve(device)
    prompts = torch.as_tensor(prompts).to(dev)
    batch, prompt_len = prompts.shape
    cache = tf.init_cache(cfg, batch, max_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for i in range(prompt_len):
        logits, cache = tf.decode_step(params, cfg, prompts[:, i:i + 1],
                                       cache, i)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    tokens = logits.argmax(dim=-1)[:, None]
    outputs, chosen_from = [tokens], [logits]
    t0 = time.perf_counter()
    for step in range(gen_len - 1):
        logits, cache = tf.decode_step(params, cfg, tokens, cache,
                                       prompt_len + step)
        tokens = logits.argmax(dim=-1)[:, None]
        outputs.append(tokens)
        chosen_from.append(logits)
    _sync(dev)
    return Generated(torch.cat(outputs, dim=1),
                     torch.stack(chosen_from, dim=1), prefill_s,
                     time.perf_counter() - t0)


def main(argv=None) -> Generated:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = get_arch(ARCH).make_smoke_config()
    params = tf.init(cfg, seed=args.seed, device=dev)
    prompts = torch.randint(
        0, cfg.vocab, (BATCH, PROMPT_LEN),
        generator=torch.Generator().manual_seed(args.seed + 1))

    out = generate(params, cfg, prompts, GEN_LEN, MAX_LEN, dev)
    print(f"prefill {PROMPT_LEN} tokens x {BATCH} seqs: "
          f"{out.prefill_s:.2f}s")
    print(f"decoded {GEN_LEN} tokens x {BATCH} seqs in {out.decode_s:.2f}s "
          f"({BATCH * GEN_LEN / out.decode_s:.0f} tok/s)")
    print("generated ids (first seq):", out.ids[0].tolist())
    return out


if __name__ == "__main__":
    main()
