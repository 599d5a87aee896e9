#!/usr/bin/env python3
"""The port's 8-bit quantizer codes against the JAX package's, in many
processes at once.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/quantizer_parity.py --copies 6 --runs 20

Each run starts ``--copies`` processes together (the load); each process
encodes the values of ``tests/test_torch_inners.py::test_quantizer_matches_jax``
(both signs, both sides) and every half-code boundary +-8 ulps with the
port's ``quantize_stacked``, with the JAX
package's, and with numpy steps that are correctly rounded (an f64 division
and square root rounded to f32), and prints how many codes the port has
apart from each.  The script prints one JSON line per run and a summary,
and exits 1 if any process found a code apart.  A check tool: it imports
JAX, which the port never does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cases():
    import numpy as np

    for side in ("left", "right"):
        for signed in (True, False):
            rng = np.random.default_rng(1 + signed)
            shape = (3, 7, 300) if side == "left" else (3, 300, 7)
            x = (rng.standard_normal(shape) * 0.01).astype(np.float32)
            if not signed:
                x = x * x
            if side == "left":
                x[1, 2, :256] = 0.0
            else:
                x[1, :256, 2] = 0.0
            yield side, signed, x
            b = code_boundaries(signed)
            yield side, signed, (b if side == "left" else np.swapaxes(b, -1, -2).copy())


def code_boundaries(signed: bool):
    """Every half-code boundary +-8 f32 ulps, in rows of 256 that each hold
    a 1.0: where a square root or division 1 ulp off moves a code."""
    import numpy as np

    k = np.arange(255 if not signed else 127)
    b = (((k + 0.5) / 255.0) ** 2 if not signed else (k + 0.5) / 127.0).astype(np.float32)
    v = np.stack([(b.view(np.int32) + d).view(np.float32) for d in range(-8, 9)]).ravel()
    v = np.clip(v, 0.0, 1.0).astype(np.float32)
    rows = -(-v.size // 255)
    x = np.zeros((rows, 256), np.float32)
    x[:, 0] = 1.0
    x.reshape(-1)[np.flatnonzero(np.arange(x.size) % 256)[:v.size]] = v
    return x.reshape(1, rows, 256)


def rounded_codes(x, side: str, signed: bool):
    """The 8-bit encoding in numpy with every f32 step correctly rounded:
    the division and the square root in f64, rounded to f32 (exact for one
    such operation on f32 operands)."""
    import numpy as np

    xs = x if side == "left" else np.swapaxes(x, -1, -2)
    n = xs.shape[-1]
    nb = -(-n // 256)
    xb = np.pad(xs, [(0, 0)] * (xs.ndim - 1) + [(0, nb * 256 - n)])
    xb = xb.reshape(xs.shape[:-1] + (nb, 256)).astype(np.float32)
    absmax = np.abs(xb).max(axis=-1)
    scale = np.where(absmax > 0, absmax, np.float32(1.0)).astype(np.float32)
    rel = (xb.astype(np.float64) / scale[..., None].astype(np.float64)).astype(np.float32)
    if signed:
        q = np.clip(np.round(rel * np.float32(127.0)), -127, 127) + 127
    else:
        rel = np.clip(rel, np.float32(0.0), np.float32(1.0))
        rel = np.sqrt(rel.astype(np.float64)).astype(np.float32)
        q = np.clip(np.round(rel * np.float32(255.0)), 0, 255)
    codes = q.astype(np.uint8).reshape(xs.shape[:-1] + (nb * 256,))[..., :n]
    return codes if side == "left" else np.swapaxes(codes, -1, -2)


def one_process() -> dict:
    """Codes apart in this process: port vs JAX, port vs correctly rounded."""
    import numpy as np
    import torch

    from repro_torch.kernels.lowrank_update import quantize as qz

    import jax.numpy as jnp

    from repro.kernels.lowrank_update import quantize as jax_qz

    out = {"vs_jax": 0, "vs_rounded": 0, "codes": 0}
    for side, signed, x in _cases():
        tc = qz.quantize_stacked(torch.from_numpy(x.copy()), side, signed)[0].numpy()
        out["codes"] += tc.size
        out["vs_rounded"] += int((tc != rounded_codes(x, side, signed)).sum())
        jc = np.asarray(jax_qz.quantize_stacked(jnp.asarray(x), side, signed)[0])
        out["vs_jax"] += int((tc != jc).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--copies", type=int, default=6, help="processes per run")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(one_process()))
        return 0
    env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    apart = 0
    for run in range(args.runs):
        procs = [subprocess.Popen([sys.executable, __file__, "--child"], env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(args.copies)]
        outs = []
        for p in procs:
            stdout, _ = p.communicate()
            if p.returncode != 0:
                raise SystemExit(f"a copy exited {p.returncode}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
        apart += sum(o["vs_jax"] + o["vs_rounded"] for o in outs)
        print(json.dumps({"run": run, "copies": outs}), flush=True)
    print(json.dumps({"runs": args.runs, "copies": args.copies, "codes_apart": apart}))
    return 1 if apart else 0


if __name__ == "__main__":
    sys.exit(main())
