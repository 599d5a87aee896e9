"""Batched serving on the port, from ``examples/serve_decode.py``: prefill
a batch of prompts, then decode greedily with the static engine's ring KV
cache (or SSM state for the mamba/hymba archs).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch llama3-8b   # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch mamba2-370m --device cpu

Smoke-size configs, as the reference's; the serving path is the full
one.  The static engine decodes greedily (no temperature).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models import build_model, count_params
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"[serve] {args.arch} ({count_params(params) / 1e6:.2f}M smoke)")

    gen = torch.Generator(device=model.device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                     generator=gen, device=model.device, dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (args.batch, 8, cfg.d_model), generator=gen, device=model.device) * 0.1
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(
            (args.batch, cfg.enc_frames, cfg.d_model), generator=gen, device=model.device) * 0.1

    eng = ServeEngine(model, params, capacity=args.prompt_len + args.new_tokens + 8)
    t0 = time.perf_counter()
    out = eng.generate(batch, max_new_tokens=args.new_tokens)
    toks = out.tokens.cpu()  # waits for the card
    dt = time.perf_counter() - t0
    n = args.batch * args.new_tokens
    print(f"[serve] {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s incl. warm-up)")
    for i in range(min(args.batch, 2)):
        print(f"  seq{i}: {toks[i].tolist()}")


if __name__ == "__main__":
    main()
