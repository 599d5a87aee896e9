#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases; any failure raises and the script exits non-zero:

1. build   -- compile every CUDA kernel of the serving path from
              ``src/repro_torch/csrc`` (one nvcc per source, all started
              together) and print the card's name and power limit.
2. kernels -- each kernel against its plain PyTorch version at the serving
              path's shapes, in f32 and bf16, within the tolerances in
              ``TOL``; then its device time per call (torch.profiler)
              beside its plain version's, a one-call PyTorch yardstick's
              where one exists, and its bound on the H100 (bytes over
              3.35 TB/s or operations over the dtype's peak, whichever is
              larger).  ``call_ms`` adds the host's launch time.
3. serve   -- full-width llama3-8b (32 layers, bf16, seeded random weights)
              through ``ContinuousEngine(max_slots=4, page_size=16)``: 8
              requests, prompts of 64..1024 tokens, 32 new tokens each,
              staggered arrivals and a pool too small for four long
              requests, so admission waits, pages recycle and every slot
              turns over.  Checks every request's budget, the drained pool
              and each kernel's launch count; then request 0's prefill and
              first decode-step logits on the paged kernel path against the
              static engine's ring cache with plain exact attention.
4. report  -- one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
              last ``{"ok": true, "device": {...}}``.  Per-case detail goes
              to ``chiprun_out/chip_smoke.json``.

The script imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): device memory rate, and the operation
# rate for each input type (bf16 on the tensor cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel vs plain version, per dtype: |kernel - plain| <= atol + rtol*|plain|.
# f32: both sum in f32 in different orders (2e-5 is the JAX repo's own
# flash-attention tolerance).  bf16: the output rounds to 8 significant
# bits, so one bf16 ulp (2^-7 relative) apart is agreement; attention also
# rounds its probabilities to bf16 in the plain version only.
TOL = {
    "rmsnorm": {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0**-7)},
    "flash_attention_fwd": {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2.0**-7)},
    "paged_decode_attention": {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2.0**-7)},
}

KERNELS = {
    "rmsnorm": {
        "route": "triton",
        "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:30",
    },
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:117",
    },
    "paged_decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/flash_attention_decode/kernel.py:111",
    },
}

SEED = 0
PAGE_SIZE = 16
MAX_SLOTS = 4
NEW_TOKENS = 32
PROMPT_LENS = [1024, 128, 517, 1000, 255, 777, 64, 333]
ARRIVALS = [0, 0, 1, 2, 4, 8, 12, 20]
POOL_PAGES = 160  # usable pages: fewer than four 1024-token requests need


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` between CUDA events around ``iters``
    back-to-back calls: the device time, or the host's launch time where
    that is longer (small kernels launched from Python)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call of ``fn``: the summed durations of every
    kernel (and copy) it ran, from torch.profiler, over ``iters`` calls.
    A profiler session has come back empty on the H100 now and then; it is
    asked again, and after three empty sessions the time is ``call_ms``,
    which bounds the device time from above (and the log says so)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_device_us(e) for e in prof.key_averages())
        if total_us > 0:
            return total_us / 1e3 / iters
    log("torch.profiler recorded no device time three times: CUDA events instead")
    return call_ms(fn, iters, warmup)


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    got32, want32 = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got32 - want32).abs()
    bad = ~torch.isfinite(got32) | (err > atol + rtol * want32.abs())
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} elements off, max abs "
            f"err {max_err:.3e} (atol {atol}, rtol {rtol})"
        )
    return max_err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(results):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_attention_decode.kernel import (
        paged_decode_attention_kernel,
    )
    from repro_torch.kernels.flash_attention_decode.ref import (
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.serve.kv_cache import pages_needed

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, label, dtype, err, main, timing):
        case = {"kernel": name, "case": label, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "tolerance": TOL[name][str(dtype).split(".")[-1]]}
        case.update(timing)
        cases.append(case)
        log(f"{name} {label} {case['dtype']}: max_abs_err {err:.3e} "
            + " ".join(f"{k} {v}" for k, v in timing.items()))
        r = results[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        if main:
            r.update(timing)

    # -- rmsnorm: a decode tick's rows and a prefill's rows -----------------
    rms_lib = getattr(F, "rms_norm", None)
    for rows in (4, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            x = randn(rows, 4096, dtype=dtype)
            scale = 1.0 + randn(4096, scale=0.1)
            got = rmsnorm(x, scale, 1e-5)
            want = rmsnorm_ref(x, scale, 1e-5)
            torch.cuda.synchronize()
            err = check_close(f"rmsnorm ({rows},4096) {dn}", got, want, *TOL["rmsnorm"][dn])
            es = x.element_size()
            b_ms, b_by = bound(2 * rows * 4096 * es + 4096 * 4, 4 * rows * 4096, dn)
            scale_lib = scale.to(dtype)  # F.rms_norm takes the weight in x's dtype
            timing = {
                "ms": device_ms(lambda: rmsnorm(x, scale, 1e-5)),
                "call_ms": call_ms(lambda: rmsnorm(x, scale, 1e-5)),
                "plain_ms": device_ms(lambda: rmsnorm_ref(x, scale, 1e-5)),
                "library_ms": (
                    device_ms(lambda: rms_lib(x, (4096,), scale_lib, 1e-5))
                    if rms_lib else None
                ),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            record("rmsnorm", f"({rows},4096)", dtype, err,
                   rows == 4 and dtype == torch.bfloat16, timing)

    # -- flash prefill: llama3-8b heads, causal, ragged lengths -------------
    def pairs(sq, sk, causal, window, q_offset):
        n = 0
        for i in range(sq):
            qpos = i + q_offset
            hi = min(sk - 1, qpos) if causal else sk - 1
            lo = max(0, qpos - window + 1) if window else 0
            n += max(0, hi - lo + 1)
        return n

    def sdpa(q, k, v, causal):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        try:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        except TypeError:  # older torch: no enable_gqa
            g = q.shape[2] // k.shape[2]
            kt, vt = kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1)
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    flash_cases = [(s, s, 0, 0) for s in (128, 517, 1024)]
    flash_cases += [(517, 517, 128, 0), (128, 256, 0, 128)]  # window; q_offset
    for sq, sk, window, q_offset in flash_cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q = randn(1, sq, 32, 128, dtype=dtype)
            k = randn(1, sk, 8, 128, dtype=dtype)
            v = randn(1, sk, 8, 128, dtype=dtype)
            kw = dict(causal=True, window=window, q_offset=q_offset)
            got = flash_attention_fwd(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            label = f"S={sq} Sk={sk} window={window} q_offset={q_offset}"
            err = check_close(f"flash {label} {dn}", got, want,
                              *TOL["flash_attention_fwd"][dn])
            es = q.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
            ops = 4 * 128 * 32 * pairs(sq, sk, True, window, q_offset)
            b_ms, b_by = bound(nbytes, ops, dn)
            has_library = window == 0 and q_offset == 0 and sq == sk
            timing = {
                "ms": device_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
                "call_ms": call_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
                "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, **kw)),
                "library_ms": (device_ms(lambda: sdpa(q, k, v, True))
                               if has_library else None),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            record("flash_attention_fwd", label, dtype, err,
                   sq == 1024 and dtype == torch.bfloat16, timing)

    # -- paged decode: llama3-8b heads, ps=16, ragged fills incl. empty ------
    fills = [0, 129, 517, 1056]  # empty slot, ragged, ragged, a full slot
    mp = pages_needed(max(fills), PAGE_SIZE)
    for window in (0, 128):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            table = torch.full((4, mp), -1, dtype=torch.int32)
            nxt = 1
            for i, n in enumerate(fills):
                for j in range(pages_needed(n, PAGE_SIZE)):
                    table[i, j] = nxt
                    nxt += 1
            n_pages = nxt + 3  # a few never-referenced pages of garbage
            pk = randn(n_pages, PAGE_SIZE, 8, 128, scale=50.0)
            pv = randn(n_pages, PAGE_SIZE, 8, 128, scale=50.0)
            used = table[table >= 0].long().to(dev)
            pk[used] = randn(used.numel(), PAGE_SIZE, 8, 128)
            pv[used] = randn(used.numel(), PAGE_SIZE, 8, 128)
            pk, pv = pk.to(dtype), pv.to(dtype)
            table = table.to(dev)
            lens = torch.tensor(fills, dtype=torch.int32, device=dev)
            q = randn(4, 1, 32, 128, dtype=dtype)
            got = paged_decode_attention_kernel(q, pk, pv, table, lens, window=window)
            want = paged_decode_attention_ref(q, pk, pv, table, lens, window=window)
            torch.cuda.synchronize()
            label = f"fills={fills} ps={PAGE_SIZE} window={window}"
            err = check_close(f"paged {label} {dn}", got, want,
                              *TOL["paged_decode_attention"][dn])
            if not bool((got[0] == 0).all()):
                raise AssertionError(f"paged {label} {dn}: empty slot is not exactly 0")
            live = sum(n - (max(0, n - window) if window else 0) for n in fills)
            es = q.element_size()
            nbytes = 2 * q.numel() * es + 2 * live * 8 * 128 * es + table.numel() * 4 + 16
            b_ms, b_by = bound(nbytes, 4 * 32 * 128 * live, dn)
            timing = {
                "ms": device_ms(lambda: paged_decode_attention_kernel(
                    q, pk, pv, table, lens, window=window)),
                "call_ms": call_ms(lambda: paged_decode_attention_kernel(
                    q, pk, pv, table, lens, window=window)),
                "plain_ms": device_ms(lambda: paged_decode_attention_ref(
                    q, pk, pv, table, lens, window=window)),
                "library_ms": None,  # no single PyTorch call reads a page table
                "bound_ms": b_ms, "bound_by": b_by,
            }
            record("paged_decode_attention", label, dtype, err,
                   window == 0 and dtype == torch.bfloat16, timing)
    return cases


# ---------------------------------------------------------------------------
# phase 3: serve full-width llama3-8b through the continuous engine
# ---------------------------------------------------------------------------


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def serve(cfg, dev: str = "cuda"):
    """Phase 3 (see the module docstring); ``dev="cpu"`` rehearses it at a
    small size without a card."""
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kv_cache as kvc
    from repro_torch.serve import paged_decode as pgd
    from repro_torch.serve.engine import ContinuousEngine

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = tfm.serving_params(
        model.init(torch.Generator(device=dev).manual_seed(SEED)), cfg
    )
    sync()
    log(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"params made and cast in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in PROMPT_LENS]

    eng = ContinuousEngine(
        model, params, max_slots=MAX_SLOTS, page_size=PAGE_SIZE,
        max_seq_len=max(PROMPT_LENS) + NEW_TOKENS, num_pages=POOL_PAGES + 1,
    )
    for p, a in zip(prompts, ARRIVALS):
        eng.submit(p, NEW_TOKENS, arrival=a)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    results = eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches = counters.snapshot()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    n_req, ticks, nl = len(PROMPT_LENS), eng.decode_steps, cfg.n_layers
    emitted = sum(len(r.tokens) for r in results.values())
    log(f"served {len(results)} requests, {emitted} tokens, {eng.total_ticks} "
        f"ticks ({ticks} decode steps) in {wall:.3f} s: {emitted / wall:.1f} tokens/s; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"launches {launches}")
    if sorted(results) != list(range(n_req)):
        raise AssertionError(f"finished requests {sorted(results)}")
    for rid, r in results.items():
        if len(r.tokens) != NEW_TOKENS or r.finish_reason != "length":
            raise AssertionError(f"request {rid}: {len(r.tokens)} tokens, {r.finish_reason}")
    if eng.kv.allocator.used_pages != 0:
        raise AssertionError(f"pool not drained: {eng.kv.allocator.used_pages} pages in use")
    total_ticks = eng.total_ticks
    del eng  # frees the pool; the serving params stay in ``params``
    profile = profile_serving(model, params) if dev == "cuda" else None
    waited = [r.admit_tick - r.arrival for r in results.values()]
    reserved = sum(kvc.pages_needed(n + NEW_TOKENS, PAGE_SIZE) for n in PROMPT_LENS)
    if max(waited) <= 0 or reserved <= POOL_PAGES:
        raise AssertionError("scenario did not make admission wait and pages recycle")
    expect = {
        "rmsnorm": (2 * nl + 1) * (ticks + n_req),
        "paged_decode_attention": nl * ticks,
        "flash_attention_fwd": nl * n_req,
    }
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")

    # Request 0: paged kernel path vs the static engine's path (ring cache,
    # plain exact attention), both bf16, feeding both the same first token.
    # The bar is the bf16 noise floor: the static path's distance to the
    # same model in f32.
    p0 = torch.as_tensor(prompts[0], device=dev)[None]
    n0 = kvc.pages_needed(p0.shape[1] + 1, PAGE_SIZE)
    kv = kvc.PagedKVCache.build(cfg, 1, PAGE_SIZE, 1 + n0, n0, device=dev)
    row = torch.from_numpy(kv.admit(0, p0.shape[1] + 1)).to(dev)
    prefill_k, cache = model.prefill(params, {"tokens": p0})
    pgd.write_prompt(kv.pages_k, kv.pages_v, cache.k[:, 0], cache.v[:, 0], cache.pos[0], row)
    kv.seq_lens[0] = p0.shape[1]
    tok0 = prefill_k.argmax(dim=-1).to(torch.int32)
    pt, sl = kv.device_tables()
    decode_k, _, _ = pgd.make_paged_step(model)(
        params, kv.pages_k, kv.pages_v, pt, sl,
        torch.ones(1, dtype=torch.bool, device=dev), tok0,
    )
    del kv, cache
    exact = build_model(cfg.with_(attn_impl="exact"), device=dev)
    prefill_s, cache_s = exact.prefill(params, {"tokens": p0}, p0.shape[1] + 1)
    decode_s, _ = exact.decode(params, cache_s, {"token": tok0[:, None]})
    del cache_s, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    cfg32 = cfg.with_(attn_impl="exact", dtype=torch.float32)
    exact32 = build_model(cfg32, device=dev)
    params32 = exact32.init(torch.Generator(device=dev).manual_seed(SEED))
    prefill_f, cache_f = exact32.prefill(params32, {"tokens": p0}, p0.shape[1] + 1)
    decode_f, _ = exact32.decode(params32, cache_f, {"token": tok0[:, None]})
    del params32, cache_f
    parity = {}
    for what, k_, s_, f_ in (("prefill", prefill_k, prefill_s, prefill_f),
                             ("decode1", decode_k, decode_s, decode_f)):
        err, noise = rel_l2(k_, s_), rel_l2(s_, f_)
        tol = max(2.0 * noise, 1e-3)
        parity[what] = {
            "rel_l2_kernel_vs_static": err, "rel_l2_static_bf16_vs_f32": noise,
            "tolerance": tol, "max_abs_kernel_vs_static": float((k_ - s_).abs().max()),
            "argmax_equal": bool((k_.argmax(-1) == s_.argmax(-1)).all()),
            "finite": bool(torch.isfinite(k_).all()),
        }
        log(f"request 0 {what} logits: {parity[what]}")
        if not parity[what]["finite"] or err > tol:
            raise AssertionError(f"request 0 {what} logits disagree: {parity[what]}")
    if results[0].tokens[0] != int(tok0[0]):
        log("note: the engine's first token for request 0 differs from the lone run")
    return {
        "requests": n_req, "tokens": emitted, "ticks": total_ticks,
        "decode_steps": ticks, "wall_s": wall, "tokens_per_s": emitted / wall,
        "max_memory_allocated": peak, "launches": launches, "expected": expect,
        "admission_waits": waited, "pages_reserved": reserved,
        "pool_pages": POOL_PAGES, "request0_parity": parity, "profile": profile,
    }


def profile_serving(model, params):
    """Device time by kernel over a short continuous run under
    torch.profiler: 4 requests of 512 tokens admitted together, then 23
    decode ticks.  Device busy share = summed kernel time / host wall time
    (one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ContinuousEngine

    eng = ContinuousEngine(model, params, max_slots=4, page_size=PAGE_SIZE,
                           max_seq_len=512 + 24)
    rng = np.random.default_rng(SEED + 1)
    for _ in range(4):
        eng.submit(rng.integers(0, model.cfg.vocab_size, (512,)), 24)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    groups = {"matmul": 0.0, "flash_attention_fwd": 0.0,
              "paged_decode_attention": 0.0, "rmsnorm": 0.0, "other": 0.0}
    kernels = []
    for e in prof.key_averages():
        us = _device_us(e)
        if us <= 0 or e.key.startswith(("cuda", "aten::", "Memcpy", "Memset")):
            continue
        name = e.key
        low = name.lower()
        if "flash_fwd" in low:
            g = "flash_attention_fwd"
        elif "paged_decode" in low:
            g = "paged_decode_attention"
        elif "rmsnorm" in low:
            g = "rmsnorm"
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma")):
            g = "matmul"
        else:
            g = "other"
        groups[g] += us / 1e3
        kernels.append((us / 1e3, e.count, name[:90]))
    kernels.sort(reverse=True)
    host_ops = sorted(
        ((e.self_cpu_time_total / 1e3, e.count, e.key[:60]) for e in prof.key_averages()
         if e.self_cpu_time_total > 0),
        reverse=True,
    )
    busy = sum(groups.values())
    out = {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "decode_steps": eng.decode_steps, "ms_by_group": groups,
        "top_kernels": [{"ms": t, "count": c, "name": n} for t, c, n in kernels[:12]],
        "top_host_ops": [{"self_cpu_ms": t, "count": c, "name": n} for t, c, n in host_ops[:15]],
    }
    log(f"profile: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({out['device_busy_share']:.3f}), {eng.decode_steps} decode steps")
    log("profile by group (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))
    for t, c, n in kernels[:8]:
        log(f"  {t:9.3f} ms  x{c:<6d} {n}")
    log("profile, host self time of the top ops (ms):")
    for t, c, n in host_ops[:10]:
        log(f"  {t:9.3f} ms  x{c:<6d} {n}")
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")  # f32 products in full f32 (no TF32), as the port runs
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    results = {name: dict(name=name, **meta) for name, meta in KERNELS.items()}
    t0 = time.perf_counter()
    cases = kernel_cases(results)
    log(f"kernels vs plain versions: {len(cases)} cases passed in "
        f"{time.perf_counter() - t0:.1f} s")

    from repro_torch.configs.registry import get_config

    served = serve(get_config("llama3-8b"))  # full width and depth, bf16
    for name, r in results.items():
        r["launches"] = served["launches"].get(name, 0)
        if r["launches"] <= 0:
            raise AssertionError(f"{name} never launched on the serving path")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernels": list(results.values()), "cases": cases,
         "serve": served}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
