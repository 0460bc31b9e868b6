"""The model zoo's configurations as data (a copy of ``repro.configs``),
and the dry-run's four input shapes (:mod:`repro_torch.configs.shapes`)."""
from repro_torch.configs.registry import ARCHS, ASSIGNED, EXTRA_ARCHS, get, reduced
from repro_torch.configs.shapes import SHAPES, applicable, input_specs

__all__ = ["ARCHS", "ASSIGNED", "EXTRA_ARCHS", "get", "reduced", "SHAPES",
           "applicable", "input_specs"]
