"""FL model zoo — the registry behind ``train.py --model``.

:class:`FLModel` bundles what the federation loop needs: ``init``,
``loss_fn``, ``accuracy`` and the ``layout`` that maps the module's
parameters onto the columns of the reference's client weight matrix
(:mod:`repro_torch.core.pytree`).

  ``cnn``               — the paper's MNIST CNN (§IV.D), f32; the default.
  ``transformer_tiny``  — bf16 row-token transformer with an int32
                          ``pos_ids`` buffer; exercises native-dtype
                          federation (a bf16 W) and the buffer contract.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import cnn, tiny_transformer


class FLModel(NamedTuple):
    """What the FL driver needs from a model.

    ``init(generator, device=...) -> params`` (a dict of tensors),
    ``loss_fn(params, batch)`` on a ``{'x', 'y'}`` batch,
    ``accuracy(params, x, y)``, and ``layout``: ``(parameter, reference
    leaf, permutation)`` triples in the reference's flatten order.
    """

    name: str
    init: Callable
    loss_fn: Callable
    accuracy: Callable
    layout: tuple


_REGISTRY: dict[str, FLModel] = {}


def register_model(model: FLModel) -> None:
    _REGISTRY[model.name] = model


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def make_model(name: str) -> FLModel:
    if name not in _REGISTRY:
        raise ValueError(f"unknown model '{name}' "
                         f"(registered: {', '.join(available_models())})")
    return _REGISTRY[name]


register_model(FLModel(name="cnn", init=cnn.init, loss_fn=cnn.loss_fn,
                       accuracy=cnn.accuracy, layout=cnn.REF_LAYOUT))
register_model(FLModel(name="transformer_tiny", init=tiny_transformer.init,
                       loss_fn=tiny_transformer.loss_fn,
                       accuracy=tiny_transformer.accuracy,
                       layout=tiny_transformer.REF_LAYOUT))
