"""Serving launcher: static-batch or continuous-batching generation,
from ``src/repro/launch/serve.py``, with seeded random weights or trained
ones restored from a checkpoint.  Runs on the card unless ``--device cpu``
is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --smoke --device cpu \
        --continuous     # moe, vlm: the paged engine; ssm, hybrid, audio: the slot-cache engine
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b --smoke --device cpu \
        --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke --device cpu \
        --continuous --ckpt /path/to/checkpoint_dir     # newest verified step

``--ckpt`` reads the params of the newest checkpoint whose param leaves
verify (``train/checkpoint.load_params_latest``), written by the port's
trainer or the JAX package's alike.

vlm and audio requests carry the family's prefix, zeros as in the JAX
launcher (``prefix_extras``, ``src/repro/launch/serve.py:54-65``):
``n_patches`` patch embeddings (8 under ``--smoke``) or ``enc_frames``
frame embeddings.  The patches also take KV positions, so here (unlike the
JAX launcher, whose cache holds only prompt + new tokens + a page) the
cache capacity counts them too.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint dir: restore newest verified params")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (staggered arrivals)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.with_(dtype=torch.float32)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    # each leaf in its serving dtype as it is drawn: deepseek-moe-16b's f32
    # tree and its bf16 copy would not fit one card together
    params = model.init(gen, serving=True)
    if args.ckpt:
        from repro_torch.train.checkpoint import load_params_latest

        params, step = load_params_latest(args.ckpt, params)
        print(f"[serve] restored params from {args.ckpt} step {step}")
    rng = np.random.default_rng(args.seed + 1)

    def prefix_extras(batch=None):
        """The family's prefix, zeros, with a leading batch axis if given."""
        lead = () if batch is None else (batch,)
        if cfg.family == "vlm":
            n = 8 if args.smoke else cfg.n_patches
            return {"patch_embeds": torch.zeros(lead + (n, cfg.d_model))}
        if cfg.family == "audio":
            return {"frame_embeds": torch.zeros(lead + (cfg.enc_frames, cfg.d_model))}
        return {}

    prefix_kv = prefix_extras().get("patch_embeds", torch.zeros(0)).shape[0]
    if args.continuous:
        eng = ContinuousEngine(
            model, params,
            max_slots=args.max_slots,
            max_seq_len=prefix_kv + args.prompt_len + args.new_tokens + args.page_size,
            page_size=args.page_size,
        )
        del params  # the engine keeps the serving cast
        for i in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, (args.prompt_len,))
            eng.submit(prompt, args.new_tokens, arrival=i, extras=prefix_extras() or None)
        t0 = time.perf_counter()
        results = eng.run()
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        emitted = sum(len(r.tokens) for r in results.values())
        print(f"[serve] continuous on {model.device}: {len(results)} requests, "
              f"{emitted} tokens in {eng.total_ticks} ticks, {dt:.3f} s")
        print(results[min(results)].tokens.tolist())
        return

    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    ), **prefix_extras(args.batch)}
    eng = ServeEngine(model, params,
                      capacity=prefix_kv + args.prompt_len + args.new_tokens + 8)
    del params
    out = eng.generate(batch, max_new_tokens=args.new_tokens)
    print(f"[serve] generated {tuple(out.tokens.shape)} on {model.device}")
    print(out.tokens[0].tolist())


if __name__ == "__main__":
    main()
