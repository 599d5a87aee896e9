"""Process-level runtime presets, from ``src/repro/launch/runtime.py``:
PyTorch, NCCL, CUDA and allocator environment where the reference sets
``XLA_FLAGS``.

This module imports neither torch nor jax: the CUDA caching allocator
reads ``PYTORCH_CUDA_ALLOC_CONF`` at its first allocation, CUDA reads
``CUDA_DEVICE_MAX_CONNECTIONS`` when it creates a context, and NCCL its
variables when a communicator is made, so every function here runs before
the first CUDA init.  Entry points call :func:`apply_runtime_preset` under
their ``__main__`` guard (``launch/dryrun.py``); importing a module never
changes the environment.

The reference's two rules:

1. **Compose, never clobber.**  ``PYTORCH_CUDA_ALLOC_CONF`` is a
   comma-separated ``key:value`` list: the preset's entries are appended,
   and a key the user already set keeps the user's value.  Every other
   variable is written only where it is absent.
2. **Declare, don't shell out.**  What a running process cannot set
   (``LD_PRELOAD`` of tcmalloc, which the dynamic linker reads at start)
   comes back as advisory ``export`` lines from :func:`shell_exports`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, MutableMapping, Optional, Sequence, Tuple

ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"

# ---------------------------------------------------------------------------
# presets: each entry with the reason it is there
# ---------------------------------------------------------------------------

# The CUDA caching allocator's options (PyTorch, "CUDA semantics: optimizing
# memory usage with PYTORCH_CUDA_ALLOC_CONF").
_OVERLAP_ALLOC: Tuple[str, ...] = (
    # segments that grow in place: the bucket stacks, FSDP's gathered
    # blocks and the refresh's sketches come in many sizes, and fixed
    # segments fragment under them
    "expandable_segments:True",
)

_OVERLAP_ENV: Dict[str, str] = {
    # one hardware work queue (CUDA's environment variables): kernels start
    # in issue order, so a collective issued before the compute it should
    # hide under is scheduled first (Megatron-LM sets it for its overlap)
    "CUDA_DEVICE_MAX_CONNECTIONS": "1",
    # a collective that fails or times out aborts its communicator and
    # tears the process down (torch.distributed's NCCL variables): a rank
    # whose peer died exits instead of hanging
    "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
    # async collectives hold their inputs by stashing them, not with
    # record_stream (torch.distributed's NCCL variables): the allocator
    # can reuse those blocks as soon as the collective is done
    "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
}

_DRYRUN_ENV: Dict[str, str] = {
    # the dry run builds on the meta device and allocates nothing: no card
    # is initialized, even where one is present (CUDA's environment
    # variables)
    "CUDA_VISIBLE_DEVICES": "",
}

PRESETS: Dict[str, Dict[str, object]] = {
    # training: collective / compute overlap, allocator and fault hygiene
    "overlap": {"alloc_conf": _OVERLAP_ALLOC, "env": _OVERLAP_ENV},
    # the meta-device dry run (launch/dryrun.py)
    "dryrun": {"alloc_conf": (), "env": _DRYRUN_ENV},
}

# tcmalloc must be preloaded by the dynamic linker (PyTorch's performance
# tuning guide): setting LD_PRELOAD inside a running interpreter does
# nothing, so it is an advisory shell export only.
_SHELL_ONLY: Dict[str, str] = {
    "LD_PRELOAD": "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
}


def _key(entry: str) -> str:
    """``expandable_segments:True`` -> ``expandable_segments``."""
    return entry.split(":", 1)[0].strip()


def compose_alloc_conf(existing: str, new_entries: Sequence[str]) -> str:
    """Append ``new_entries`` to a ``PYTORCH_CUDA_ALLOC_CONF`` value.  An
    entry whose key ``existing`` already has is dropped (the user's value
    wins); the existing entries come first, then the additions in order."""
    have_parts = [p.strip() for p in existing.split(",") if p.strip()]
    have = {_key(p) for p in have_parts}
    added: List[str] = []
    for entry in new_entries:
        key = _key(entry)
        if key in have:
            continue
        have.add(key)
        added.append(entry)
    return ",".join(have_parts + added)


def apply_runtime_preset(name: str, env: Optional[MutableMapping[str, str]] = None
                         ) -> Mapping[str, str]:
    """Apply preset ``name`` to ``env`` (default ``os.environ``), before the
    first CUDA init.  ``PYTORCH_CUDA_ALLOC_CONF`` is composed with, never
    replaced; the other variables are set only where absent.  Returns the
    variables actually written."""
    if name not in PRESETS:
        raise ValueError(f"unknown runtime preset {name!r}; have {sorted(PRESETS)}")
    if env is None:
        env = os.environ
    preset = PRESETS[name]
    written: Dict[str, str] = {}
    entries: Sequence[str] = preset.get("alloc_conf", ())  # type: ignore[assignment]
    if entries:
        composed = compose_alloc_conf(env.get(ALLOC_CONF, ""), entries)
        if composed != env.get(ALLOC_CONF, ""):
            env[ALLOC_CONF] = composed
            written[ALLOC_CONF] = composed
    extra: Mapping[str, str] = preset.get("env", {})  # type: ignore[assignment]
    for key, val in extra.items():
        if key not in env:  # user settings win
            env[key] = val
            written[key] = val
    return written


def shell_exports(name: str = "overlap") -> str:
    """Advisory ``export`` lines for what a running process cannot apply,
    then the preset's own variables: a launcher script sources them, the
    Python entry point applies the rest."""
    if name not in PRESETS:
        raise ValueError(f"unknown runtime preset {name!r}; have {sorted(PRESETS)}")
    lines = [f"export {k}={v}" for k, v in _SHELL_ONLY.items()]
    preset = PRESETS[name]
    entries: Sequence[str] = preset.get("alloc_conf", ())  # type: ignore[assignment]
    if entries:
        lines.append(f"export {ALLOC_CONF}={','.join(entries)}")
    for key, val in preset.get("env", {}).items():  # type: ignore[union-attr]
        lines.append(f"export {key}={val}")
    return "\n".join(lines)
