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

Dtypes are kept, with one refusal: numpy has no bf16, so a bf16 leaf is
not saved (a widening on the way would come back as f32); train states
hold f32 params, f32 moments and uint8 codes.  A leaf loads to the dtype
and device of the skeleton's leaf; f32 -> bf16 rounds to nearest even, as
JAX's ``astype`` does.  The sharded format of ZeRO runs waits for the
distributed slice (ROADMAP queue 1 item 11): its checkpoints raise.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lowrank import LowRankOptState, flatten_with_path
from repro_torch.train.state import TrainState

_MANIFEST = "manifest.json"


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
        for entry in files:
            if _sha256(os.path.join(cdir, entry["file"])) != entry["sha256"]:
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
    for path, leaf in items:
        arr = _host(leaf)
        fname = _sanitize(path) + ".npy"
        fpath = os.path.join(tmp, fname)
        io.save_leaf(fpath, arr)
        manifest["leaves"][path] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": _sha256(fpath),
        }
        nbytes += arr.nbytes
        del arr
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


def _read_leaf(cdir: str, path: str, entry: Dict[str, Any], like, verify: bool):
    """One leaf from disk, checked against its checksum and ``like``'s
    shape, in ``like``'s dtype (and device, for a tensor)."""
    fpath = os.path.join(cdir, entry["file"])
    if verify and _sha256(fpath) != entry["sha256"]:
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


def _manifest(cdir: str) -> Dict[str, Any]:
    with open(os.path.join(cdir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") == "sharded":
        raise NotImplementedError(
            f"{cdir} is a sharded checkpoint, which the port does not read yet "
            "(ROADMAP queue 1 item 11)"
        )
    return manifest


def load_params_latest(base_dir: str, params_like, verify: bool = True) -> Tuple[Any, int]:
    """Train -> serve: fill a params skeleton (a nested dict of tensors)
    from the newest checkpoint whose ``.params`` leaves are all intact,
    walking past corrupt or partial ones, without building an optimizer
    state.  Each leaf takes the skeleton's dtype and device, so a bf16
    serving skeleton gets the f32 training weights rounded to nearest
    even.  Returns ``(params, step)``."""
    first_err: Optional[BaseException] = None
    for step in reversed(checkpoint_dirs(base_dir)):
        cdir = _step_dir(base_dir, step)
        try:
            manifest = _manifest(cdir)

            def get(path, like):
                entry = manifest["leaves"].get(path)
                if entry is None:
                    raise KeyError(f"checkpoint missing param leaf {path}")
                return _read_leaf(cdir, path, entry, like, verify)

            return _map(params_like, ".params", get), step
        except (OSError, ValueError, KeyError) as e:
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    raise FileNotFoundError(f"no checkpoints under {base_dir}")


class CheckpointManager:
    """Saves and restores states under ``base_dir`` (``CheckpointManager``
    of the reference, l.347, without the sharded format).  ``canonicalize``
    / ``localize`` (``train/state.checkpoint_converters``) turn the storage
    layout into the per-leaf one on save and back on load.  ``last_save``
    and ``last_load`` record the bytes and seconds of the latest of each."""

    def __init__(
        self,
        base_dir: str,
        keep: int = 3,
        canonicalize=None,
        localize=None,
        io: Optional[CheckpointIO] = None,
        save_retries: int = 2,
        retry_backoff_s: float = 0.05,
    ):
        self.base_dir = base_dir
        self.keep = keep
        self.canonicalize = canonicalize  # storage -> serialized layout
        self.localize = localize  # serialized -> storage layout
        self.io = io or CheckpointIO()
        self.save_retries = save_retries  # extra attempts after a failure
        self.retry_backoff_s = retry_backoff_s  # doubles per retry
        self.retries_performed = 0
        self.fallbacks: List[Tuple[int, str]] = []
        self.last_save: Optional[Dict[str, float]] = None
        self.last_load: Optional[Dict[str, float]] = None
        self._save_ordinal = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def rebind(self, canonicalize=None, localize=None) -> None:
        """Re-target the manager at an optimizer re-bucketed at a new rank:
        new layout converters, the same manager (its save in flight is
        drained first; retry counts and retention carry on)."""
        self.wait()  # converters must not change under a background write
        self.canonicalize = canonicalize
        self.localize = localize

    # ---- save ----

    def save(self, state, step: int, blocking: bool = True,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Save ``state`` as the checkpoint of ``step``; ``meta`` goes into
        the manifest (``checkpoint_meta``)."""
        # a dead background write surfaces before any new work (retention
        # in particular) can mask it
        self._raise_if_failed()
        self.wait()  # one save in flight at a time
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
        ordinal = self._save_ordinal
        self._save_ordinal += 1

        def work():
            delay = self.retry_backoff_s
            t1 = time.perf_counter()
            for attempt in range(self.save_retries + 1):
                try:
                    self.io.begin(ordinal, attempt)
                    nbytes = _write_checkpoint(self.base_dir, step, items, self.keep, self.io,
                                               meta)
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
        it is canonicalized to match the manifest, and the result is
        localized back."""
        step = step if step is not None else latest_step(self.base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.base_dir}")
        t0 = time.perf_counter()
        cdir = _step_dir(self.base_dir, step)
        manifest = _manifest(cdir)
        if self.canonicalize is not None:
            state_like = self.canonicalize(state_like)
        nbytes = 0

        def get(path, like):
            nonlocal nbytes
            entry = manifest["leaves"].get(path)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {path}")
            out = _read_leaf(cdir, path, entry, like, verify)
            nbytes += (out.nbytes if isinstance(out, np.ndarray)
                       else out.numel() * out.element_size())
            return out

        loaded = tree_fill(state_like, get)
        del state_like
        if self.localize is not None:
            loaded = self.localize(loaded)
        self.last_load = {"step": step, "bytes": nbytes, "seconds": time.perf_counter() - t0}
        return loaded

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
