"""Serving launcher: static-batch or continuous-batching generation with
seeded random weights, from ``src/repro/launch/serve.py``.  Runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke --device cpu

Restoring a checkpoint goes through ``repro_torch.bridge`` and comes with
the training slice.
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
    params = model.init(gen)
    rng = np.random.default_rng(args.seed + 1)

    if args.continuous:
        eng = ContinuousEngine(
            model, params,
            max_slots=args.max_slots,
            max_seq_len=args.prompt_len + args.new_tokens + args.page_size,
            page_size=args.page_size,
        )
        del params  # the engine keeps the serving cast
        for i in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, (args.prompt_len,))
            eng.submit(prompt, args.new_tokens, arrival=i)
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
    )}
    eng = ServeEngine(model, params, capacity=args.prompt_len + args.new_tokens + 8)
    del params
    out = eng.generate(batch, max_new_tokens=args.new_tokens)
    print(f"[serve] generated {tuple(out.tokens.shape)} on {model.device}")
    print(out.tokens[0].tolist())


if __name__ == "__main__":
    main()
