#!/usr/bin/env python3
"""Kernel 9, the power-iteration step Y = G (G^T Q), on one CUDA card: its
agreement with the plain version, its accuracy against an f64 product made
on the card, and its time, in one or more source trees, in turns.

    python3 tools/power_iter_bench.py                     # this checkout
    python3 tools/power_iter_bench.py --time --tree build/parent --tree . \\
        --tree . --tree build/parent                      # A/B in turns

Each tree runs in a process of its own (its ``src/repro_torch`` builds its
own ``csrc/power_iter.cu``), under ``--timeout``: a kernel that hangs ends
its own process only.

Per tree: (1) small and ragged shapes, f32 and bf16 G, against the plain
version within ``chip_smoke.TOL``; (2) one slice of the mlp bucket (m 4096,
n 14336, k' 2056, unit-normal G, orthonormal Q) and a wide-range slice
(G's rows and Q's columns scaled by 2^-20 ... 2^20): kernel and plain
version each against an f64 product on the card, as max |err| / max |Y|
and as the worst element's share of the ``TOL`` bar (``bar_share``; 1
is the bar) against the plain version; (3) with ``--time``, device ms of
the kernel, the plain version and ``bmm(G, bmm(G^T, Q))`` at the mlp
bucket B 12 (k' 2056, 1032, 1064), online_pca's k' 512, deepseek-moe-16b's
expert bucket and llava-next-34b's mlp bucket (``chip_smoke``'s family
shapes), beside two bounds (the f32 CUDA cores; the same operations as
an f32-accurate split's three TF32 products on the tensor cores).

Prints one JSON line per tree and writes them all, with the card's name
and power limit, to ``chiprun_out/power_iter_bench.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMALL = [(2, 40, 72, 12), (2, 256, 640, 40), (1, 300, 130, 130), (2, 1100, 130, 8),
         (3, 176, 100, 40), (1, 1100, 1536, 1064)]
MAIN = (4096, 14336)
# (B, m, n, k') beside chip_smoke's: the mlp bucket at the sara sketch's
# k' 4 r + 8 for r 512, 256, 264, and online_pca's k' = r 512
TIMED = [(12, *MAIN, 2056), (12, *MAIN, 1032), (12, *MAIN, 1064), (12, *MAIN, 512)]


def family_timed(cs) -> list:
    """deepseek-moe-16b's expert bucket at r 256 and llava-next-34b's mlp
    bucket at r 512, as ``chip_smoke``'s family kernel cases take them."""
    out = []
    for run, i, r in (("train_moe", 0, 256), ("train_vlm", -1, 512)):
        d, n, _, b, _ = cs.FAMILY_TRAIN_RUNS[run][5][i]
        out.append((b, d, n, min(4 * r + 8, d)))
    return out


def worker(tree: Path, label: str, timed: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs  # with this checkout's package; then the tree's:
    for name in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.power_iter.kernel import power_iter_batched
    from repro_torch.kernels.power_iter.ref import power_iter_ref

    if not torch.cuda.is_available():
        raise SystemExit("power_iter_bench: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    atol, rtol = cs.TOL["power_iter_batched"]["float32"]
    # this source alone, with nvcc's output (build_all would build all eight)
    log = build._finish("power_iter", build._start("power_iter"))
    row = {"tree": label, "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "Used" in ln or "spill" in ln]}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def orthonormal(b, d, k):
        return torch.linalg.qr(randn(b, d, k))[0].contiguous()

    def bar_share(got, want):
        bar = atol * float(want.abs().max()) + rtol * want.abs()
        return float(((got - want).abs() / bar).max())

    small = []
    for b, m, n, kp in SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            g = (0.1 * randn(b, m, n)).to(dtype)
            q = orthonormal(b, m, kp)
            got, want = power_iter_batched(g, q), power_iter_ref(g, q)
            torch.cuda.synchronize()
            small.append({"shape": [b, m, n, kp], "dtype": str(dtype).split(".")[-1],
                          "max_abs_err": float((got - want).abs().max()),
                          "bar_share": bar_share(got, want)})
    row["small"] = small
    row["small_ok"] = all(c["bar_share"] <= 1 for c in small)

    def accuracy(g, q):
        y64 = torch.matmul(g.double(), torch.matmul(g.double().transpose(1, 2), q.double()))
        scale = float(y64.abs().max())
        got, plain = power_iter_batched(g, q), power_iter_ref(g, q)
        torch.cuda.synchronize()
        out = {"kernel_err_f64": float((got.double() - y64).abs().max()) / scale,
               "plain_err_f64": float((plain.double() - y64).abs().max()) / scale,
               "kernel_rms_err_f64": float((got.double() - y64).pow(2).mean().sqrt()) / scale,
               "plain_rms_err_f64": float((plain.double() - y64).pow(2).mean().sqrt()) / scale,
               "bar_share": bar_share(got, plain)}
        del y64, got, plain
        torch.cuda.empty_cache()
        return out

    m, n = MAIN
    g, q = randn(1, m, n), orthonormal(1, m, 2056)
    row["main_slice"] = accuracy(g, q)
    rows_scale = torch.exp2(torch.randint(-20, 21, (1, m, 1), generator=gen, device=dev).float())
    cols_scale = torch.exp2(torch.randint(-20, 21, (1, 1, 2056), generator=gen, device=dev).float())
    row["wide_range"] = accuracy((g * rows_scale).contiguous(), (q * cols_scale).contiguous())
    del g, q
    torch.cuda.empty_cache()

    if timed:
        times = []
        for b, d, k, kp in TIMED + family_timed(cs):
            g, q = randn(b, d, k), orthonormal(b, d, kp)
            times.append({"B": b, "m": d, "n": k, "kp": kp, **cs.power_iter_timing(g, q, 3)})
            del g, q
            torch.cuda.empty_cache()
        row["timed"] = times
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="source tree (repeatable)")
    ap.add_argument("--time", action="store_true", help="also time the bucket cases")
    ap.add_argument("--timeout", type=int, default=900, help="seconds per tree")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker[0]).resolve(), args.worker[1], args.time)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=False).stdout.strip()
    print(smi)
    runs = [(Path(t), t) for t in args.tree] or [(ROOT, ".")]
    rows, failed = [], 0
    for tree, label in runs:
        cmd = [sys.executable, __file__, "--worker", str(tree), label]
        cmd += ["--time"] * args.time
        try:
            res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired:
            rows.append({"tree": label, "error": f"timed out after {args.timeout} s"})
            failed = 1
            print(json.dumps(rows[-1]), flush=True)
            continue
        if res.returncode != 0:
            rows.append({"tree": label, "error": f"exit {res.returncode}"})
            failed = 1
        else:
            rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "power_iter_bench.json").write_text(json.dumps({"card": smi, "runs": rows}, indent=1))
    return failed


if __name__ == "__main__":
    sys.exit(main())
