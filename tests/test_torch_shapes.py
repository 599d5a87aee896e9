"""Shapes and cells of the port (``configs/base.ShapeConfig`` / ``SHAPES``,
``configs/specs.py``, ``configs/registry.cells``, the launcher's
``--shape``) against the JAX package's: the same 40 cells in the same
order, and for every arch and shape the same batch specs and decode-cache
skeleton, leaf by leaf in shape and dtype (the port's are meta tensors,
JAX's ``ShapeDtypeStruct``s).  ``concrete_train_batch`` draws from a
``torch.Generator``, so only its keys, shapes and dtypes are JAX's."""
import dataclasses

import jax
import pytest
import torch

from repro.configs import specs as jax_specs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import cells as jax_cells
from repro.configs.registry import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import specs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import SUBQUADRATIC, cells, get_config, list_archs
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model

torch.set_num_threads(1)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _leaves(tree):
    """(shape, dtype) of every leaf, the port's NamedTuples and dicts in
    JAX's flattening order."""
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), _dtype(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _jax_leaves(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(tree)]


def test_cells_and_shapes_equal_jax():
    assert cells() == jax_cells()
    assert cells(include_skipped=True) == jax_cells(include_skipped=True)
    assert len(cells(include_skipped=True)) == 40 and len(cells()) == 32
    assert {a for a, s, ok in cells(include_skipped=True) if s == "long_500k" and ok} \
        == set(SUBQUADRATIC)
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert isinstance(shape, ShapeConfig)
        assert dataclasses.asdict(shape) == dataclasses.asdict(JAX_SHAPES[name])


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model = build_model(cfg, device="meta")
    jmodel = jax_build_model(jcfg)
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        for fn in ("train_batch_specs", "prefill_batch_specs", "decode_batch_specs"):
            got = getattr(specs, fn)(cfg, shape)
            want = getattr(jax_specs, fn)(jcfg, jshape)
            assert list(got) == list(want), (fn, name)
            for k in want:
                assert got[k].device.type == "meta"
                assert (tuple(got[k].shape), _dtype(got[k])) == \
                    (tuple(want[k].shape), str(want[k].dtype)), (fn, name, k)
        if shape.kind == "decode":
            got = specs.decode_cache_specs(model, shape)
            want = jax_specs.decode_cache_specs(jmodel, jshape)
            assert _leaves(got) == _jax_leaves(want), name
    with pytest.raises(ValueError, match="meta"):
        specs.decode_cache_specs(build_model(get_config(arch, smoke=True), device="cpu"),
                                 SHAPES["decode_32k"])


@pytest.mark.parametrize("arch", list_archs())
def test_concrete_train_batch_shapes_equal_jax(arch):
    cfg = get_config(arch, smoke=True)
    jcfg = jax_get_config(arch, smoke=True)
    got = specs.concrete_train_batch(cfg, 2, 16, torch.Generator().manual_seed(0))
    want = jax_specs.concrete_train_batch(jcfg, 2, 16)
    assert list(got) == list(want)
    for k in want:
        assert (tuple(got[k].shape), _dtype(got[k])) == \
            (tuple(want[k].shape), str(want[k].dtype)), k
    assert int(got["tokens"].max()) < cfg.vocab_size
    again = specs.concrete_train_batch(cfg, 2, 16, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_launcher_takes_the_reference_shapes():
    """``--shape`` names one of ``SHAPES`` (an unknown name is an argparse
    error before any work) and, as in the reference, leaves the run as it
    is: the batch is ``--seq`` / ``--batch``."""
    with pytest.raises(SystemExit):
        train_launcher.main(["--shape", "train_1k", "--device", "cpu"])
    import contextlib
    import io
    import tempfile

    outs = []
    for extra in ([], ["--shape", "decode_32k"]):
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as ck, contextlib.redirect_stdout(buf):
            train_launcher.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                                 "--steps", "2", "--tau", "2", "--rank", "8",
                                 "--ckpt-dir", ck, "--no-recovery"] + extra)
        outs.append([ln for ln in buf.getvalue().splitlines() if ln.startswith("[train] done")])
    assert outs[0] == outs[1] and len(outs[0]) == 1
