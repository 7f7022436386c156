"""Batched serving (twin of ``repro/launch/serve.py``): prefill a
batch of prompts, then decode greedily, reporting per-phase latencies.

Runs a reduced architecture (any id of ``configs.PORTED_IDS``:
``mamba2-130m``, ``yi-6b``, ``chatglm3-6b``, ``minicpm-2b``,
``granite-20b``, ``llama-3.2-vision-11b``, ``seamless-m4t-large-v2``;
the reference's defaults: 2 layers, d_model 256) over the synthetic
vocab, with the reference's zero stubs for the VLM's media and the
encoder-decoder's frames; ``--device`` picks the card (default ``cuda``,
which raises without one) or ``cpu``. The full widths run through the
same :func:`generate` in ``chip_smoke.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch llama-3.2-vision-11b --batch 4 --prompt-len 64 --gen 32
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.model import Batch


class Generation(NamedTuple):
    tokens: torch.Tensor     # (B, gen) int64, greedy
    prefill_s: float         # prompt to first-token logits, synchronised
    decode_s: float          # all ``gen`` decode steps, synchronised


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: M.LM, batch: Batch, cfg, gen: int) -> Generation:
    """Prefill ``batch.tokens`` (B, S) (with the batch's media or frames),
    then ``gen`` greedy decode steps: the first generated token is the
    prefill's argmax, each step feeds the last token back (the reference's
    loop)."""
    device = batch.tokens.device
    cache_len = batch.tokens.shape[1] + gen
    t0 = time.perf_counter()
    logits, state = M.prefill(params, batch, cfg, cache_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out = []
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(gen):
        out.append(nxt)
        logits, state = M.decode_step(params, nxt, state, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(device)
    return Generation(torch.cat(out, dim=1), prefill_s,
                      time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    cfg = get_config(args.arch).reduced(n_layers=args.layers,
                                        d_model=args.d_model)
    params = M.init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg, device)
    b = args.batch
    tokens = torch.randint(
        0, cfg.vocab_size, (b, args.prompt_len), device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    # the reference's stubs: precomputed media and frame embeddings
    media = (torch.zeros((b, cfg.n_media_tokens, cfg.d_model), device=device)
             if cfg.cross_attn_every else None)
    frames = (torch.zeros((b, cfg.encoder_seq or 16, cfg.d_model),
                          device=device) if cfg.is_encoder_decoder else None)
    out = generate(params, Batch(tokens=tokens, media=media, frames=frames),
                   cfg, args.gen)
    print(json.dumps({
        "arch": cfg.name, "batch": b, "prompt_len": args.prompt_len,
        "generated": args.gen,
        "prefill_s": out.prefill_s,
        "decode_s_per_token": out.decode_s / args.gen,
        "sample_output": out.tokens[0, :16].tolist(),
    }))


if __name__ == "__main__":
    main()
