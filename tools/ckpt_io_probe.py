#!/usr/bin/env python3
"""What bounds a checkpoint's save and load: each stage of the port's
checkpoint I/O (``src/repro_torch/train/checkpoint.py``) timed alone on one
large f32 leaf, as a checkpoint writes and reads it.

    python3 tools/ckpt_io_probe.py [--gb 2] [--dir build/ckpt_io_probe] [--threads 1,4,8]

Stages: device -> host copy (on a card), ``np.save``, a read of the file,
SHA-256 of the file (on 1 and more threads, one file each, as a manager
hashing several leaves at once would), ``np.load``, host -> device copy.
Each prints seconds and GB/s; the device's name and power limit head the
output where there is a card.  The file's reads follow its write, so they
come from the page cache (warm).  The directory is removed at the end.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gb", type=float, default=2.0, help="size of the leaf")
    ap.add_argument("--dir", default="build/ckpt_io_probe")
    ap.add_argument("--threads", default="1,4,8", help="thread counts for SHA-256")
    args = ap.parse_args(argv)
    cuda = torch.cuda.is_available()
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip().splitlines()[0]}; {os.cpu_count()} CPUs")
    else:
        print(f"no card: host stages only; {os.cpu_count()} CPUs")
    n = int(args.gb * 1e9) // 4
    shutil.rmtree(args.dir, ignore_errors=True)
    os.makedirs(args.dir)
    rows = {}

    def timed(name, fn, nbytes):
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        s = time.perf_counter() - t
        rows[name] = (s, nbytes / s / 1e9)
        print(f"{name:28s} {s:8.3f} s  {nbytes / s / 1e9:7.2f} GB/s")
        return out

    try:
        dev = torch.randn(n, device="cuda") if cuda else torch.randn(n)
        nbytes = n * 4
        host = timed("device -> host", lambda: dev.cpu().numpy(), nbytes) if cuda \
            else dev.numpy()
        paths = [os.path.join(args.dir, f"leaf{i}.npy") for i in range(max(
            int(t) for t in args.threads.split(",")))]
        timed("np.save", lambda: np.save(paths[0], host, allow_pickle=False), nbytes)
        for p in paths[1:]:
            shutil.copyfile(paths[0], p)

        def read(p):
            with open(p, "rb") as f:
                while f.read(1 << 24):
                    pass

        timed("read", lambda: read(paths[0]), nbytes)
        for t in (int(x) for x in args.threads.split(",")):
            with cf.ThreadPoolExecutor(t) as ex:
                timed(f"sha256, {t} file(s) on {t} thread(s)",
                      lambda: list(ex.map(_sha256, paths[:t])), t * nbytes)
        arr = timed("np.load", lambda: np.load(paths[0], allow_pickle=False), nbytes)
        if cuda:
            timed("host -> device", lambda: torch.from_numpy(arr).to("cuda"), nbytes)
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
