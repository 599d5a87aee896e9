"""Checkpoints in the JAX package's canonical per-leaf format, from
``src/repro/train/checkpoint.py``: one ``.npy`` per leaf plus a
``manifest.json`` that maps each leaf's ``jax.tree_util.keystr`` path to
its file, shape, dtype and SHA-256.  A checkpoint written by either package
loads into the other.

  * **paths** -- ``tree_items`` walks a state as JAX flattens its own:
    a ``TrainState``'s ``.params['blocks']['q_proj']``, ``.opt_state.step``
    (int32, shape ()), ``.opt_state.key`` (uint32 (2,): the port's draw
    source, ``TorchDraws.key``), ``.opt_state.leaves['embed'].projector``
    and ``.inner.<field>``, with the port's flat list of per-leaf states
    keyed by their params' paths; ``None`` (an empty inner) and ``()`` (no
    buckets) write nothing.  ``tree_fill`` is its inverse.
  * **atomicity** -- a save writes ``step_XXXXXXXX.tmp/`` and commits it
    with ``os.replace`` and an fsync of the parent only after the manifest
    is fsynced, so a crash never leaves a loadable torn checkpoint.
  * **integrity and fallback** -- every leaf is checksummed and load
    verifies; ``load_latest`` walks newest to oldest past checkpoints that
    do not verify, and retention never deletes the newest verified one.
  * **blocking and async saves** -- a blocking save streams leaf by leaf
    (device -> host -> ``np.save``), so it holds one leaf on the host at a
    time; ``blocking=False`` first copies every leaf to the host on the
    caller's thread, as JAX's ``device_get`` does, and writes on a
    background thread (the whole state in host memory: ~17 GB for 4-layer
    llama3-8b).  Failed writes are retried with backoff; a failure past the
    budget surfaces on the next ``wait`` or ``save``.
  * **I/O seam** -- every byte written goes through a ``CheckpointIO``
    (``train/faults.FaultyCheckpointIO`` injects faults through it).
  * **schedule state** -- ``save(..., meta=)`` writes the manifest's
    ``meta`` (the rank(s) a scheduled run's bucket geometry was built at),
    ``checkpoint_meta`` reads it back, and ``CheckpointManager.rebind``
    re-targets a manager at an optimizer re-bucketed at a new rank.

  * **shard-parallel save** (``shard_spec=``, a ``ShardSpec``) -- a ZeRO
    run's state is written in its storage layout, each writer saving only
    its block of rows of every bucket stack (``<leaf>.s{k}_of_{S}.npy``)
    and a fsynced per-shard manifest; the coordinator (the writer of shard
    0) writes the replicated leaves, waits at the commit barrier for all
    ``num_shards`` shard manifests, refuses ones that disagree (an
    ``IOError`` into the retry path), merges their checksums into one
    ``manifest.json`` (``format: "sharded"``) and commits.  The writers
    are the processes of a data-parallel run (``local_shard_ids``) or one
    process emulating them all.  A state holding one block of rows
    (``ShardSpec.holds``) writes that block.
  * **elastic resume** -- a sharded checkpoint written at N shards loads
    into a state padded for M: the N blocks are concatenated, the writer's
    pad rows dropped (``canonical_rows`` in the manifest), and the rows
    padded again for M (and cut to this process's block where the
    skeleton holds one).  ``load`` dispatches on the manifest's
    ``format``, so both formats live in one directory.

Dtypes are kept, with one refusal: numpy has no bf16, so a bf16 leaf is
not saved (a widening on the way would come back as f32); train states
hold f32 params, f32 moments and uint8 codes.  A leaf loads to the dtype
and device of the skeleton's leaf; f32 -> bf16 rounds to nearest even, as
JAX's ``astype`` does.
"""
from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lowrank import LowRankOptState, flatten_with_path
from repro_torch.train.state import TrainState

_MANIFEST = "manifest.json"
_SHARD_MANIFEST_FMT = "manifest.shard{:05d}.json"
_SHARD_MANIFEST_RE = re.compile(r"^manifest\.shard(\d{5})\.json$")
# the leaves whose rows split across the shard writers: the bucket stacks
_SHARDED_LEAF_RE = re.compile(r"\.opt_state\.buckets\[(\d+)\]")
_SHARD_FILE_RE = re.compile(r"\.s\d{5}_of_\d{5}\.npy$")


class ShardSpec(NamedTuple):
    """Who writes what in a shard-parallel save (``checkpoint.py:87``).

    ``num_shards`` writers in all (the optimizer's ``state_shards``);
    ``shard_ids`` the shards this process writes: its own one in a
    data-parallel run, all of them where one process emulates the fleet,
    none on a process that holds a copy of a shard another writes (the
    data ranks of a ``pod``-mode pod).  The writer of shard 0 is the
    coordinator.  ``commit_timeout_s`` bounds its wait for the other shard
    manifests.  ``holds``: the shard whose block of rows this process's
    bucket stacks hold (a ZeRO step's state), or None for the full padded
    stacks; loads cut the same block."""

    num_shards: int
    shard_ids: Tuple[int, ...]
    commit_timeout_s: float = 60.0
    poll_interval_s: float = 0.01
    holds: Optional[int] = None

    @property
    def is_coordinator(self) -> bool:
        return 0 in self.shard_ids


def local_shard_ids(num_shards: int) -> Tuple[int, ...]:
    """The shards this process writes, from the default process group: all
    of them in a one-process run, its rank where there are ``num_shards``
    processes, and where the processes are a multiple of that (copies of
    each shard along a minor mesh axis, as in ``pod`` mode) the shard it
    holds on the first process holding it, none on the others."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return tuple(range(num_shards))
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % num_shards:
        raise ValueError(f"{world} processes cannot write {num_shards} shards")
    copies = world // num_shards
    return (rank // copies,) if rank % copies == 0 else ()


class CheckpointIO:
    """Byte-level checkpoint I/O, replaceable to inject faults in tests.

    ``begin`` is called once per write attempt with the manager's save
    ordinal and the 0-based retry attempt; ``commit`` renames atomically
    (``os.replace``) and fsyncs the parent so the rename survives a crash."""

    def begin(self, save_ordinal: int, attempt: int) -> None:
        pass

    def save_leaf(self, fpath: str, arr: np.ndarray) -> None:
        np.save(fpath, arr, allow_pickle=False)

    def write_manifest(self, mpath: str, manifest: Dict[str, Any]) -> None:
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())

    def commit(self, tmp: str, final: str) -> None:
        os.replace(tmp, final)
        _fsync_dir(os.path.dirname(final))


def _fsync_dir(path: str) -> None:
    """Record a rename durably; best effort where directories reject fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# the tree walk: JAX's paths over the port's trees
# ---------------------------------------------------------------------------


def _map(node, path: str, fn: Callable[[str, Any], Any]):
    """``node`` rebuilt with ``fn(path, leaf)`` in place of every leaf, the
    paths being ``jax.tree_util.keystr``'s for the same tree in JAX."""
    if node is None:
        return None
    if isinstance(node, TrainState):
        param_paths = [p for p, _ in flatten_with_path(node.params)]
        return TrainState(_map(node.params, path + ".params", fn),
                          _map_opt_state(node.opt_state, path + ".opt_state", fn, param_paths))
    if isinstance(node, LowRankOptState):
        return _map_opt_state(node, path, fn, None)
    if isinstance(node, dict):
        return {k: _map(node[k], f"{path}[{k!r}]", fn) for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map(getattr(node, f), f"{path}.{f}", fn) for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_map(x, f"{path}[{i}]", fn) for i, x in enumerate(node))
    return fn(path, node)


def _map_opt_state(st: LowRankOptState, path: str, fn, param_paths):
    """JAX's ``LowRankOptState(step, key, leaves, buckets)``: the host step
    as an int32 leaf, the draw source as the key, the flat per-leaf list
    keyed by the params' paths (by index for a bare optimizer state).  The
    draw source writes its key with ``key()`` and is rebuilt by its class's
    ``from_key`` (``TorchDraws``, or a source with the same two methods)."""
    draws = st.draws
    if not (callable(getattr(draws, "key", None)) and hasattr(type(draws), "from_key")):
        raise TypeError(f"a checkpoint needs a draw source with key() and from_key, not "
                        f"{type(draws)}")
    step = fn(path + ".step", np.asarray(st.step, dtype=np.int32))
    key = fn(path + ".key", draws.key())
    if param_paths is None:
        param_paths = [f"[{i}]" for i in range(len(st.leaves))]
    leaves = [_map(leaf, f"{path}.leaves{pp}", fn) for pp, leaf in zip(param_paths, st.leaves)]
    buckets = tuple(_map(b, f"{path}.buckets[{i}]", fn) for i, b in enumerate(st.buckets))
    return LowRankOptState(step=int(np.asarray(step)),
                           draws=type(draws).from_key(np.asarray(key), draws.device),
                           leaves=leaves, buckets=buckets)


def tree_items(tree) -> List[Tuple[str, Any]]:
    """(JAX keystr path, leaf) of every leaf, in JAX's flattening order;
    a ``TrainState``'s step and draw source come as numpy arrays."""
    out: List[Tuple[str, Any]] = []
    _map(tree, "", lambda path, leaf: out.append((path, leaf)) or leaf)
    return out


def tree_fill(like, get: Callable[[str, Any], Any]):
    """The inverse of ``tree_items``: ``like`` rebuilt with
    ``get(path, like_leaf)`` in place of each leaf."""
    return _map(like, "", get)


def _host(x, copy: bool = False) -> np.ndarray:
    """A leaf as a C-ordered numpy array (the bytes JAX's ``np.asarray``
    gives), refusing dtypes numpy cannot hold.  ``copy`` makes sure it
    shares no memory with ``x`` (a CPU tensor's ``numpy()`` would)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                "a bf16 leaf is not saved: numpy has no bf16, and a widened copy "
                "would load back as f32"
            )
        copy = copy and x.device.type == "cpu"  # a device leaf is copied anyway
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.copy(order="C") if copy or not x.flags.c_contiguous else x


def _sanitize(path: str) -> str:
    return (
        path.replace("[", "_").replace("]", "").replace("'", "")
        .replace(".", "_").replace("/", "_")
    ) or "root"


def _sha256(fn: str) -> str:
    h = hashlib.sha256()
    with open(fn, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# Files hashed side by side.  SHA-256 is the slowest stage of a save and of
# a load: 0.93 GB/s on one thread of the H100 machine's host, against 3.17
# GB/s for np.save and 2.49 for np.load, and 6.71 GB/s over 8 files on 8
# threads (hashlib lets go of the GIL while it hashes; tools/ckpt_io_probe.py).
_HASH_THREADS = 8


class _Hasher:
    """SHA-256 of files on a pool of threads: ``submit`` starts a file's
    hash (a save, just after writing it; a load, for every file it will
    read, before the first read), ``get`` waits for it, re-raising what the
    read raised (a missing file), and hashes a file not submitted."""

    def __init__(self):
        self._pool = cf.ThreadPoolExecutor(_HASH_THREADS)
        self._futures: Dict[str, cf.Future] = {}

    def __enter__(self) -> "_Hasher":
        return self

    def __exit__(self, *exc) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def submit(self, fpath: str) -> None:
        if fpath not in self._futures:
            self._futures[fpath] = self._pool.submit(_sha256, fpath)

    def get(self, fpath: str) -> str:
        self.submit(fpath)
        return self._futures[fpath].result()


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def checkpoint_dirs(base: str) -> List[int]:
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(base: str) -> Optional[int]:
    steps = checkpoint_dirs(base)
    return steps[-1] if steps else None


def verify_checkpoint(base: str, step: int) -> bool:
    """Whether the manifest parses and every file's SHA-256 matches (the
    shards of a sharded checkpoint too): the predicate retention protects."""
    cdir = _step_dir(base, step)
    try:
        with open(os.path.join(cdir, _MANIFEST)) as f:
            manifest = json.load(f)
        files = list(manifest["leaves"].values())
        for entry in manifest.get("sharded", {}).values():
            if len(entry["shards"]) != int(manifest["num_shards"]):
                return False
            files.extend(entry["shards"])
        with _Hasher() as hasher:
            for entry in files:
                hasher.submit(os.path.join(cdir, entry["file"]))
            for entry in files:
                if hasher.get(os.path.join(cdir, entry["file"])) != entry["sha256"]:
                    return False
    except (OSError, ValueError, KeyError):
        return False
    return True


def checkpoint_meta(base: str, step: int) -> Dict[str, Any]:
    """The manifest's ``meta`` (``{"rank": r, "group_ranks": [...]}`` for a
    scheduled run; ``{}`` for a checkpoint without one).  Raises
    ``OSError``/``ValueError`` for a missing or torn manifest, as ``load``
    does."""
    with open(os.path.join(_step_dir(base, step), _MANIFEST)) as f:
        manifest = json.load(f)
    return dict(manifest.get("meta", {}))


def checkpoint_format(base: str, step: int) -> str:
    """The manifest's ``format``: "sharded", or "" for the canonical one."""
    with open(os.path.join(_step_dir(base, step), _MANIFEST)) as f:
        return str(json.load(f).get("format", ""))


def _write_checkpoint(base: str, step: int, items, keep: int, io: CheckpointIO,
                      meta: Optional[Dict[str, Any]] = None) -> int:
    """Write ``items`` ((path, leaf) pairs; a device leaf is copied to the
    host just before its file is written) and commit.  Returns the bytes
    of leaf data."""
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    if meta:
        manifest["meta"] = meta
    nbytes = 0
    with _Hasher() as hasher:
        for path, leaf in items:
            arr = _host(leaf)
            fname = _sanitize(path) + ".npy"
            fpath = os.path.join(tmp, fname)
            io.save_leaf(fpath, arr)
            hasher.submit(fpath)  # hashed beside the next leaf's write
            manifest["leaves"][path] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": None,
            }
            nbytes += arr.nbytes
            del arr
        for entry in manifest["leaves"].values():
            entry["sha256"] = hasher.get(os.path.join(tmp, entry["file"]))
    io.write_manifest(os.path.join(tmp, _MANIFEST), manifest)
    if os.path.exists(final):
        shutil.rmtree(final)
    io.commit(tmp, final)
    _apply_retention(base, keep)
    return nbytes


def _apply_retention(base: str, keep: int) -> None:
    """Drop all but the newest ``keep`` checkpoints, except the newest one
    that verifies: a corrupt later write must not leave nothing loadable."""
    steps = checkpoint_dirs(base)
    victims = steps[:-keep] if keep > 0 else []
    if victims:
        protected = next((s for s in reversed(steps) if verify_checkpoint(base, s)), None)
        for old in victims:
            if old != protected:
                shutil.rmtree(_step_dir(base, old), ignore_errors=True)


def _read_leaf(cdir: str, path: str, entry: Dict[str, Any], like, verify: bool,
               hasher: _Hasher):
    """One leaf from disk, checked against its checksum (from ``hasher``,
    which may have started it ahead) and ``like``'s shape, in ``like``'s
    dtype (and device, for a tensor)."""
    fpath = os.path.join(cdir, entry["file"])
    if verify and hasher.get(fpath) != entry["sha256"]:
        raise IOError(f"checksum mismatch for {path} in {cdir}")
    arr = np.load(fpath, allow_pickle=False)
    if arr.dtype.kind == "V":
        raise TypeError(f"{path} in {cdir} has dtype {arr.dtype}, which numpy cannot read")
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(
            f"shape mismatch for {path}: ckpt {arr.shape} vs state {tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return arr.astype(like.dtype)


def _map_paths(tree, prefix: str = "") -> List[str]:
    out: List[str] = []
    _map(tree, prefix, lambda path, leaf: out.append(path) or leaf)
    return out


def _prehash(hasher: _Hasher, cdir: str, manifest: Dict[str, Any], paths) -> None:
    """Start the hash of every file that the leaves at ``paths`` read."""
    for path in paths:
        entry = manifest["leaves"].get(path)
        files = [entry] if entry is not None else \
            manifest.get("sharded", {}).get(path, {}).get("shards", [])
        for f in files:
            hasher.submit(os.path.join(cdir, f["file"]))


def _manifest(cdir: str) -> Dict[str, Any]:
    with open(os.path.join(cdir, _MANIFEST)) as f:
        return json.load(f)


def load_params_latest(base_dir: str, params_like, verify: bool = True) -> Tuple[Any, int]:
    """Train -> serve: fill a params skeleton (a nested dict of tensors)
    from the newest checkpoint whose ``.params`` leaves are all intact,
    walking past corrupt or partial ones, without building an optimizer
    state (in both formats the params are replicated leaves).  Each leaf takes the skeleton's dtype and device, so a bf16
    serving skeleton gets the f32 training weights rounded to nearest
    even.  Returns ``(params, step)``."""
    first_err: Optional[BaseException] = None
    for step in reversed(checkpoint_dirs(base_dir)):
        cdir = _step_dir(base_dir, step)
        try:
            manifest = _manifest(cdir)
            with _Hasher() as hasher:
                if verify:
                    _prehash(hasher, cdir, manifest, _map_paths(params_like, ".params"))

                def get(path, like):
                    entry = manifest["leaves"].get(path)
                    if entry is None:
                        raise KeyError(f"checkpoint missing param leaf {path}")
                    return _read_leaf(cdir, path, entry, like, verify, hasher)

                return _map(params_like, ".params", get), step
        except (OSError, ValueError, KeyError) as e:
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    raise FileNotFoundError(f"no checkpoints under {base_dir}")


class CheckpointManager:
    """Saves and restores states under ``base_dir`` (``CheckpointManager``
    of the reference, l.347).  ``canonicalize`` / ``localize``
    (``train/state.checkpoint_converters``) turn the storage layout into
    the per-leaf one on save and back on load.  With ``shard_spec`` a
    state with bucket stacks is written in the shard-parallel format;
    ``canonical_rows`` (``train/state.bucket_canonical_rows``) is recorded
    for its elastic load.  ``last_save`` and ``last_load`` record the bytes
    and seconds of the latest of each.  ``writer=False`` (a data-parallel
    process other than rank 0, whose replicated state rank 0 writes)
    makes canonical saves write nothing."""

    def __init__(
        self,
        base_dir: str,
        keep: int = 3,
        canonicalize=None,
        localize=None,
        io: Optional[CheckpointIO] = None,
        save_retries: int = 2,
        retry_backoff_s: float = 0.05,
        shard_spec: Optional[ShardSpec] = None,
        canonical_rows: Optional[Dict[int, int]] = None,
        writer: bool = True,
    ):
        self.base_dir = base_dir
        self.keep = keep
        self.canonicalize = canonicalize  # storage -> serialized layout
        self.localize = localize  # serialized -> storage layout
        self.io = io or CheckpointIO()
        self.save_retries = save_retries  # extra attempts after a failure
        self.retry_backoff_s = retry_backoff_s  # doubles per retry
        self.shard_spec = shard_spec
        self.canonical_rows = dict(canonical_rows or {})
        self.writer = writer
        self.retries_performed = 0
        self.fallbacks: List[Tuple[int, str]] = []
        self.last_save: Optional[Dict[str, float]] = None
        self.last_load: Optional[Dict[str, float]] = None
        self._save_ordinal = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def rebind(self, canonicalize=None, localize=None,
               canonical_rows: Optional[Dict[int, int]] = None) -> None:
        """Re-target the manager at an optimizer re-bucketed at a new rank:
        new layout converters and bucket rows, the same manager (its save
        in flight is drained first; retry counts and retention carry on)."""
        self.wait()  # converters must not change under a background write
        self.canonicalize = canonicalize
        self.localize = localize
        self.canonical_rows = dict(canonical_rows or {})

    # ---- save ----

    def save(self, state, step: int, blocking: bool = True,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Save ``state`` as the checkpoint of ``step``; ``meta`` goes into
        the manifest (``checkpoint_meta``)."""
        # a dead background write surfaces before any new work (retention
        # in particular) can mask it
        self._raise_if_failed()
        self.wait()  # one save in flight at a time
        if self.shard_spec is not None and any(
                _SHARDED_LEAF_RE.search(path) for path, _ in tree_items(state)):
            self._save_sharded(state, step, blocking, meta)
            return
        if not self.writer:
            self._save_ordinal += 1
            return
        if self.canonicalize is not None:
            state = self.canonicalize(state)
        items = tree_items(state)
        del state
        t0 = time.perf_counter()
        if not blocking:
            # the background thread must not read tensors the loop goes on
            # to replace: snapshot every leaf on this thread
            items = [(path, _host(leaf, copy=True)) for path, leaf in items]
        snapshot_s = time.perf_counter() - t0
        self._run(lambda: _write_checkpoint(self.base_dir, step, items, self.keep, self.io,
                                            meta), step, snapshot_s, blocking)

    def _run(self, write: Callable[[], int], step: int, snapshot_s: float,
             blocking: bool) -> None:
        """One save's attempts, with retries and backoff, here or on the
        background thread; a failure past the budget is kept for the next
        ``wait`` or ``save``."""
        ordinal = self._save_ordinal
        self._save_ordinal += 1

        def work():
            delay = self.retry_backoff_s
            t1 = time.perf_counter()
            for attempt in range(self.save_retries + 1):
                try:
                    self.io.begin(ordinal, attempt)
                    nbytes = write()
                    self.last_save = {"step": step, "bytes": nbytes, "snapshot_s": snapshot_s,
                                      "write_s": time.perf_counter() - t1}
                    return
                except Exception as e:  # any failure of an attempt is retried
                    err = e
                    if attempt < self.save_retries:
                        self.retries_performed += 1
                        if delay > 0:
                            time.sleep(delay)
                            delay *= 2
            self._error = err  # surfaced on the next wait() or save()

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    # ---- shard-parallel save (checkpoint.py:474-685) ----

    def _stack_geometry(self, path: str, shape) -> Optional[Tuple[int, int, int]]:
        """(bucket, rows per shard, padded rows) of a bucket-stack leaf that
        splits across the writers, or None for a replicated leaf."""
        m = _SHARDED_LEAF_RE.search(path)
        if m is None or len(shape) < 1 or shape[0] <= 0:
            return None
        spec = self.shard_spec
        rows = int(shape[0])
        if spec.holds is not None:  # this process's block of rows
            return int(m.group(1)), rows, rows * spec.num_shards
        if rows % spec.num_shards:
            return None
        return int(m.group(1)), rows // spec.num_shards, rows

    def _save_sharded(self, state, step: int, blocking: bool,
                      meta: Optional[Dict[str, Any]]) -> None:
        """Each writer saves its own blocks of rows, in the storage layout:
        no process builds the full stacks or the canonical layout."""
        spec = self.shard_spec
        sharded_meta: Dict[str, Dict[str, Any]] = {}
        blocks: List[Tuple[str, int, Any]] = []
        repl: List[Tuple[str, Any]] = []
        for path, leaf in tree_items(state):
            geo = self._stack_geometry(path, tuple(getattr(leaf, "shape", ())))
            if geo is None:
                if spec.is_coordinator:
                    repl.append((path, leaf))
                continue
            bucket, rps, padded = geo
            sharded_meta[path] = {
                "rows_per_shard": rps, "padded_rows": padded,
                "canonical_rows": int(self.canonical_rows.get(bucket, padded)),
                "dtype": str(_host(leaf[:0]).dtype),
            }
            for k in spec.shard_ids:
                if spec.holds is None:
                    blocks.append((path, k, leaf[k * rps:(k + 1) * rps]))
                elif k == spec.holds:
                    blocks.append((path, k, leaf))
        del state
        t0 = time.perf_counter()
        if not blocking:
            blocks = [(p, k, _host(x, copy=True)) for p, k, x in blocks]
            repl = [(p, _host(x, copy=True)) for p, x in repl]
        snapshot_s = time.perf_counter() - t0
        self._run(lambda: self._write_sharded(step, sharded_meta, blocks, repl, meta),
                  step, snapshot_s, blocking)

    def _write_sharded(self, step: int, sharded_meta, blocks, repl,
                       meta: Optional[Dict[str, Any]]) -> int:
        spec = self.shard_spec
        S = spec.num_shards
        io = self.io
        os.makedirs(self.base_dir, exist_ok=True)
        final = _step_dir(self.base_dir, step)
        tmp = final + ".tmp"
        # other writers may be filling the same directory: never remove it
        os.makedirs(tmp, exist_ok=True)
        per_shard = {k: {"step": step, "num_shards": S, "shard": k, "leaves": {}}
                     for k in spec.shard_ids}
        nbytes = 0
        with _Hasher() as hasher:
            for path, k, block in blocks:
                arr = _host(block)
                fname = f"{_sanitize(path)}.s{k:05d}_of_{S:05d}.npy"
                fpath = os.path.join(tmp, fname)
                io.save_leaf(fpath, arr)
                hasher.submit(fpath)
                geo = sharded_meta[path]
                per_shard[k]["leaves"][path] = {
                    "file": fname, "sha256": None, "shape": list(arr.shape),
                    "rows_per_shard": geo["rows_per_shard"], "padded_rows": geo["padded_rows"],
                    "canonical_rows": geo["canonical_rows"], "dtype": geo["dtype"],
                }
                nbytes += arr.nbytes
                del arr
            for man in per_shard.values():
                for entry in man["leaves"].values():
                    entry["sha256"] = hasher.get(os.path.join(tmp, entry["file"]))
            for k, man in per_shard.items():
                io.write_manifest(os.path.join(tmp, _SHARD_MANIFEST_FMT.format(k)), man)
            if not spec.is_coordinator:
                # done once its shard manifests are durable: the coordinator
                # owns the barrier, the merge and the commit
                return nbytes
            repl_entries: Dict[str, Any] = {}
            for path, leaf in repl:
                arr = _host(leaf)
                fname = _sanitize(path) + ".npy"
                fpath = os.path.join(tmp, fname)
                io.save_leaf(fpath, arr)
                hasher.submit(fpath)
                repl_entries[path] = {"file": fname, "shape": list(arr.shape),
                                      "dtype": str(arr.dtype), "sha256": None}
                nbytes += arr.nbytes
                del arr
            for entry in repl_entries.values():
                entry["sha256"] = hasher.get(os.path.join(tmp, entry["file"]))
        shard_mans = self._commit_barrier(tmp, step)
        merged: Dict[str, Any] = {}
        for path, m0 in shard_mans[0]["leaves"].items():
            merged[path] = {
                "rows_per_shard": m0["rows_per_shard"],
                "padded_rows": m0["padded_rows"],
                "canonical_rows": m0["canonical_rows"],
                "shape": [m0["padded_rows"]] + list(m0["shape"][1:]),
                "dtype": m0["dtype"],
                "shards": [{"file": shard_mans[k]["leaves"][path]["file"],
                            "sha256": shard_mans[k]["leaves"][path]["sha256"]}
                           for k in range(S)],
            }
        manifest: Dict[str, Any] = {"step": step, "format": "sharded", "num_shards": S,
                                    "leaves": repl_entries, "sharded": merged}
        if meta:
            manifest["meta"] = meta
        io.write_manifest(os.path.join(tmp, _MANIFEST), manifest)
        if os.path.exists(final):
            shutil.rmtree(final)
        io.commit(tmp, final)
        _apply_retention(self.base_dir, self.keep)
        return nbytes

    def _commit_barrier(self, tmp: str, step: int) -> Dict[int, Dict]:
        """The coordinator's quorum (``checkpoint.py:629``): wait, at most
        ``commit_timeout_s``, for all ``num_shards`` shard manifests, then
        check that they agree on step, shard count, leaf set and row
        geometry.  A timeout or a disagreement raises ``IOError`` into the
        save's retries: a straggling or corrupted writer fails the attempt
        instead of hanging it or committing a torn checkpoint."""
        spec = self.shard_spec
        deadline = time.monotonic() + spec.commit_timeout_s
        found: Dict[int, Dict] = {}
        want = set(range(spec.num_shards))
        while True:
            try:
                names = os.listdir(tmp)
            except OSError:
                names = []
            for name in names:
                m = _SHARD_MANIFEST_RE.match(name)
                if not m:
                    continue
                k = int(m.group(1))
                if k in found or k not in want:
                    continue
                try:
                    with open(os.path.join(tmp, name)) as f:
                        found[k] = json.load(f)
                except (OSError, ValueError):
                    continue  # mid-write or a torn read: poll again
            if want.issubset(found):
                break
            if time.monotonic() >= deadline:
                raise IOError(
                    f"commit barrier timed out after {spec.commit_timeout_s}s waiting for "
                    f"shard manifests {sorted(want - set(found))} at step {step}")
            time.sleep(spec.poll_interval_s)
        ref = found[0]
        for k in sorted(want):
            man = found[k]
            header = (man.get("step"), man.get("num_shards"), man.get("shard"))
            if header != (step, spec.num_shards, k):
                raise IOError(f"divergent shard manifest {k}: header {header} != "
                              f"{(step, spec.num_shards, k)}")
            if set(man["leaves"]) != set(ref["leaves"]):
                raise IOError(f"divergent shard manifest {k}: leaf set differs from shard 0")
            for path, e in man["leaves"].items():
                r = ref["leaves"][path]
                if any(e[g] != r[g] for g in ("rows_per_shard", "padded_rows",
                                              "canonical_rows", "dtype")):
                    raise IOError(f"divergent shard manifest {k}: geometry for {path} "
                                  "differs from shard 0")
        return found

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err

    # ---- load ----

    def load(self, state_like, step: Optional[int] = None, verify: bool = True):
        """Fill ``state_like``'s structure from the checkpoint of ``step``
        (the newest when None).  ``state_like`` is in the storage layout;
        for a canonical checkpoint it is canonicalized to match the
        manifest and the result is localized back; a sharded one loads
        straight into the storage layout (elastic across shard counts)."""
        step = step if step is not None else latest_step(self.base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.base_dir}")
        t0 = time.perf_counter()
        cdir = _step_dir(self.base_dir, step)
        manifest = _manifest(cdir)
        sharded = manifest.get("format") == "sharded"
        if self.canonicalize is not None and not sharded:
            state_like = self.canonicalize(state_like)
        nbytes = 0
        hasher = _Hasher()

        def get(path, like):
            nonlocal nbytes
            ent = manifest.get("sharded", {}).get(path) if sharded else None
            if ent is not None:
                out = self._read_stack(cdir, path, ent, like, verify, hasher)
            else:
                entry = manifest["leaves"].get(path)
                if entry is None:
                    raise KeyError(f"checkpoint missing leaf {path}")
                out = _read_leaf(cdir, path, entry, like, verify, hasher)
            nbytes += (out.nbytes if isinstance(out, np.ndarray)
                       else out.numel() * out.element_size())
            return out

        with hasher:
            if verify:
                _prehash(hasher, cdir, manifest, _map_paths(state_like))
            loaded = tree_fill(state_like, get)
        del state_like
        if self.localize is not None and not sharded:
            loaded = self.localize(loaded)
        self.last_load = {"step": step, "bytes": nbytes, "seconds": time.perf_counter() - t0}
        return loaded

    def _read_stack(self, cdir: str, path: str, ent: Dict[str, Any], like, verify: bool,
                    hasher: _Hasher):
        """One bucket stack of a sharded checkpoint (``checkpoint.py:777``):
        the writer's blocks concatenated, its pad rows dropped, padded
        again to the skeleton's rows (or, where this process holds one
        block, to the full padded rows and cut to that block)."""
        blocks = []
        for k, srec in enumerate(ent["shards"]):
            fpath = os.path.join(cdir, srec["file"])
            if verify and hasher.get(fpath) != srec["sha256"]:
                raise IOError(f"checksum mismatch for {path} shard {k} in {cdir}")
            blocks.append(np.load(fpath, allow_pickle=False))
        arr = np.concatenate(blocks, axis=0) if len(blocks) > 1 else blocks[0]
        rows = int(ent["canonical_rows"])
        arr = arr[:rows]
        shape = tuple(like.shape)
        if tuple(arr.shape[1:]) != shape[1:]:
            raise ValueError(f"trailing-shape mismatch for {path}: ckpt {arr.shape} vs "
                             f"state {shape}")
        spec = self.shard_spec
        holds = spec.holds if spec is not None else None
        tgt = shape[0] * spec.num_shards if holds is not None else shape[0]
        if tgt < rows:
            raise ValueError(f"cannot fit {path}: {rows} canonical rows into {tgt} padded rows")
        if tgt > rows:
            arr = np.concatenate([arr, np.zeros((tgt - rows,) + arr.shape[1:], arr.dtype)])
        if holds is not None:
            arr = arr[holds * shape[0]:(holds + 1) * shape[0]]
        arr = np.ascontiguousarray(arr)
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
        return arr.astype(like.dtype)

    def load_latest(self, state_like, verify: bool = True) -> Tuple[Any, int]:
        """The newest checkpoint that loads, walking newest to oldest past
        corrupt, truncated or partial ones (each skip is recorded in
        ``fallbacks``).  Returns ``(state, step)``; when none loads, raises
        the newest one's error, as ``load`` does on one bad checkpoint."""
        first_err: Optional[BaseException] = None
        for step in reversed(checkpoint_dirs(self.base_dir)):
            try:
                return self.load(state_like, step=step, verify=verify), step
            except (OSError, ValueError, KeyError) as e:
                if first_err is None:
                    first_err = e
                self.fallbacks.append((step, repr(e)))
        if first_err is not None:
            raise first_err
        raise FileNotFoundError(f"no checkpoints under {self.base_dir}")
