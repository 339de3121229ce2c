"""``Model.input_specs`` against the JAX package's, for every arch at full
width and every ``SHAPES`` cell that ``shape_applicable`` runs: the same
input names, shapes, dtypes and logical axes (the port's inputs are
``meta`` tensors, the JAX package's ``ShapeDtypeStruct``s)."""
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.models import build_model

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}

CELLS = [(arch, shape) for arch in list_archs() for shape in SHAPES
         if shape_applicable(get_config(arch), SHAPES[shape])[0]]


def test_every_arch_has_cells():
    assert {a for a, _ in CELLS} == set(list_archs())
    assert len(CELLS) == 33        # 10 archs x 3 shapes + 3 at long_500k


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    from repro.configs import SHAPES as JAX_SHAPES
    inputs, axes = build_model(get_config(arch)).input_specs(SHAPES[shape])
    j_inputs, j_axes = jax_build_model(jax_get_config(arch)).input_specs(
        JAX_SHAPES[shape])
    assert list(inputs) == list(j_inputs)
    assert axes == j_axes
    for name, t in inputs.items():
        j = j_inputs[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(j.shape), name
        assert t.dtype == DTYPES[jnp.dtype(j.dtype)], name
