#!/usr/bin/env python3
"""Time the port's paged decode kernel on one CUDA card, in one or more
source trees, in turns.

    python3 tools/paged_decode_bench.py                  # this checkout
    python3 tools/paged_decode_bench.py --tree build/parent --tree . \\
        --tree . --tree build/parent                     # A/B in turns

Each tree runs in a process of its own (its ``src/repro_torch`` builds its
own ``csrc/paged_decode.cu``) on the two cases of ``chip_smoke.py``: the
serving case (fills [0, 129, 517, 1056], ps 16, bf16 and f32) and the
bandwidth case (32 slots of 1024 + 64 i tokens, pages shuffled, bf16).
Each case is held against the plain version within ``chip_smoke.TOL``
and timed with ``chip_smoke``'s helpers: device ms per call
(torch.profiler), ``call_ms`` (CUDA events around back-to-back calls, so
the host's launch time where that is longer) and the bytes bound.  Where
the tree's wrapper picks a cluster size (``cluster_size``), the bandwidth
and serving bf16 cases are also timed at every cluster size 1, 2, 4, 8 and
on the CUDA-core design.
Prints one JSON line per tree and writes all of them, with the card's
name and power limit, to ``chiprun_out/paged_decode_bench.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs  # with this checkout's package; then the tree's:
    for name in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.flash_attention_decode import kernel as km
    from repro_torch.kernels.flash_attention_decode.ref import paged_decode_attention_ref

    if not torch.cuda.is_available():
        raise SystemExit("paged_decode_bench: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    cases = [(cs.PAGED_FILLS, torch.bfloat16, False), (cs.PAGED_FILLS, torch.float32, False),
             (cs.PAGED_BANDWIDTH_FILLS, torch.bfloat16, True)]
    out = []
    pick = getattr(km, "cluster_size", None)
    for fills, dtype, shuffle in cases:
        dn = str(dtype).split(".")[-1]
        q, pk, pv, table, lens = cs.paged_inputs(randn, fills, dtype, shuffle, gen)
        kern = lambda: km.paged_decode_attention_kernel(q, pk, pv, table, lens)  # noqa: E731
        got = kern()
        want = paged_decode_attention_ref(q, pk, pv, table, lens)
        err = cs.check_close(f"paged {dn}", got, want, *cs.TOL["paged_decode_attention"][dn])
        del got, want
        b_ms, b_by = cs.paged_bound(q, table, fills, 0)
        row = {"case": cs.paged_label(fills, 0, shuffle), "dtype": dn, "max_abs_err": err,
               **cs.paged_plan(q, pk, table),
               "ms": cs.device_ms(kern, iters=50), "call_ms": cs.call_ms(kern, iters=50),
               "bound_ms": b_ms, "bound_by": b_by}
        row["share_of_bound"] = b_ms / row["ms"]
        if pick is not None and dtype == torch.bfloat16:
            sweep = {}
            for size in (1, 2, 4, 8):
                km.cluster_size = lambda *_a, _s=size: _s
                try:
                    sweep[size] = cs.device_ms(kern, iters=50)
                finally:
                    km.cluster_size = pick
            row["ms_by_cluster"] = sweep
            pick_design = km.design
            km.design = lambda *_a, **_k: "cuda_cores"
            try:
                row["ms_cuda_cores"] = cs.device_ms(kern, iters=50)
            finally:
                km.design = pick_design
        print(f"[bench] {tree}: {row}", file=sys.stderr, flush=True)
        out.append(row)
        del q, pk, pv, table, lens
        torch.cuda.empty_cache()
    return {"tree": str(tree), "cases": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path,
                    help="source tree to time (repeat for turns; default: this checkout)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    runs = []
    for tree in args.tree or [ROOT]:
        res = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                             stdout=subprocess.PIPE, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "paged_decode_bench.json").write_text(
        json.dumps({"card": smi, "runs": runs}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
