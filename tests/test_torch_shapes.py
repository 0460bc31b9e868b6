"""The port's dry-run shapes (``repro_torch.configs.shapes``) and
``analysis.model_flops`` against the reference's.

* ``SHAPES`` equals the reference's four shapes.
* ``applicable`` equals the reference's for all 10 x 4 (arch, shape)
  pairs, reason included.
* ``input_specs`` equals the reference's ``eval_shape`` stand-ins leaf for
  leaf (names, shapes, dtypes) for every applicable pair, and the ring
  buffer's for the windowed archs; the port's are ``meta`` tensors by
  default and FakeTensors under a FakeTensorMode.
* ``model_flops`` equals the reference's for all 40 pairs.
"""
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import get as jget
from repro.configs import shapes as jshapes
from repro.launch import analysis as janalysis
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import analysis as tanalysis
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

PAIRS = [(a, s) for a in tconfigs.ASSIGNED for s in tshapes.SHAPES]
APPLICABLE = [(a, s) for a, s in PAIRS
              if tshapes.applicable(tconfigs.get(a), s)[0]]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_shapes_equal_reference():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in tshapes.SHAPES.items():
        assert tuple(shape) == tuple(jshapes.SHAPES[name])


def test_exports():
    assert tconfigs.SHAPES is tshapes.SHAPES
    assert tconfigs.applicable is tshapes.applicable
    assert tconfigs.input_specs is tshapes.input_specs


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_applicable_equals_reference(arch, shape):
    assert tshapes.applicable(tconfigs.get(arch), shape) == \
        jshapes.applicable(jget(arch), shape)


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_input_specs_equal_reference(arch, shape):
    cfg = tconfigs.get(arch)
    rings = (False, True) if cfg.window is not None else (False,)
    for ring in rings:
        ref = _flat(jshapes.input_specs(jget(arch), shape, ring=ring))
        got = _flat(tshapes.input_specs(cfg, shape, ring=ring))
        assert sorted(got) == sorted(ref)
        for k, leaf in got.items():
            assert leaf.device.type == "meta", k
            assert tuple(leaf.shape) == tuple(ref[k].shape), k
            assert str(leaf.dtype).removeprefix("torch.") == \
                jnp.dtype(ref[k].dtype).name, k


def test_input_specs_fake_under_a_mode():
    with FakeTensorMode():
        specs = tshapes.input_specs(tconfigs.get("hymba-1.5b"), "long_500k",
                                    device="cpu")
    leaves = _flat(specs)
    assert leaves and all(isinstance(v, FakeTensor) for v in leaves.values())
    # 32 layers of a 524,288-slot KV cache: no memory behind it
    assert leaves["cache/k"].shape == (32, 1, 5, 524288, 64)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_equal_reference(arch, shape):
    assert tanalysis.model_flops(tconfigs.get(arch), tshapes.SHAPES[shape]) \
        == janalysis.model_flops(jget(arch), jshapes.SHAPES[shape])
