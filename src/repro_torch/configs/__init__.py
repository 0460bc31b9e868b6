"""The model zoo's configurations as data (a copy of ``repro.configs``).

``configs/shapes.py`` of the reference builds ``jax.ShapeDtypeStruct`` inputs
for the dry-run and waits for the port of that tooling (ROADMAP queue A.7).
"""
from repro_torch.configs.registry import ARCHS, ASSIGNED, EXTRA_ARCHS, get, reduced

__all__ = ["ARCHS", "ASSIGNED", "EXTRA_ARCHS", "get", "reduced"]
