"""User-facing optimizer factory, from ``src/repro/core/api.py``.

    from repro_torch.core import make_optimizer
    opt = make_optimizer("galore-sara-adam", params, rank=128, tau=200)
    state = opt.init(params)
    new_params, state, aux = opt.update(grads, state, params, refresh=True, apply=True)

Names compose  <projector>[-sara]? - <inner>  as in the reference:

    adam / full-adam            -> full-rank inner optimizer everywhere
    galore-adam                 -> dominant projector + Adam
    galore-sara-adam            -> SARA projector + Adam        (the paper)
    golore-adam                 -> random projector + Adam
    grass-adam                  -> row-sampling projector + Adam
    online-pca-adam             -> online subspace descent + Adam
    identity-adam               -> P = I, for tests
    fira-adam / fira-sara-adam  -> Fira residual path (dominant / SARA)
    *-adafactor, *-adam-mini, *-adam8bit, *-msgd variants likewise.

Every name builds, and every option of the reference's
``OptimizerConfig`` that the port has runs (``state_sharding="zero"`` and
``update(projected=True, shard_axes=...)`` with the data-parallel step,
``train/step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import lowrank as lowrank_lib

OptimizerConfig = lowrank_lib.OptimizerConfig
LowRankOptimizer = lowrank_lib.LowRankOptimizer

_INNERS = ("adam8bit", "adam_mini", "adam-mini", "adafactor", "msgd", "adam")
_PROJECTORS = {
    "galore": "dominant",
    "golore": "golore",
    "grass": "grass",
    "online-pca": "online_pca",
    "online_pca": "online_pca",
    "fira": "dominant",
    "identity": "identity",
}


def parse_name(name: str) -> dict:
    """Parse a composed optimizer name into config fields."""
    n = name.lower().strip()
    out: dict = {}
    inner = None
    for cand in _INNERS:  # longest-match suffix
        if n.endswith(cand):
            inner = cand.replace("-", "_")
            n = n[: -len(cand)].rstrip("-")
            break
    if inner is None:
        raise ValueError(f"cannot find inner optimizer in {name!r}")
    out["inner"] = inner

    if n in ("", "full"):
        out["method"] = "full"
        return out

    if "sara" in n:
        out["method"] = "sara"
        n = n.replace("sara", "").strip("-")
    if n.startswith("fira") or n == "fira":
        out["fira"] = True
        n = n[4:].strip("-")
        out.setdefault("method", "dominant")
    if n:
        if n not in _PROJECTORS:
            raise ValueError(f"unknown projector family {n!r} in {name!r}")
        if out.get("method") != "sara":
            # "galore-sara-adam": sara IS the selection; the family prefix
            # only names the wrapper
            out["method"] = _PROJECTORS[n]
    out.setdefault("method", "sara")
    return out


def make_optimizer(
    name: str,
    params_like: Any,
    *,
    lowrank_filter=None,
    **overrides: Any,
) -> LowRankOptimizer:
    fields = parse_name(name)
    fields.update(overrides)
    valid = {f.name for f in dataclasses.fields(OptimizerConfig)}
    unknown = set(fields) - valid
    if unknown:
        raise ValueError(f"unknown optimizer config fields: {sorted(unknown)}")
    cfg = OptimizerConfig(**fields)
    return lowrank_lib.make_lowrank_optimizer(cfg, params_like, lowrank_filter)
