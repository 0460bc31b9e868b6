"""The port's MoE layer against the reference's, on the CPU.

The reference's ``moe_apply`` (expert parallelism off: its sort-based
dispatch on one device) and the port's run on the same router inputs and
the reference's parameters, for the reduced configs of the three MoE
archs and a wider one (8 experts, top-3).  Router inputs are f32 normals
leaning towards one expert as an unbalanced router's do, and checked to
have no top-k ties (a tie's order is not part of the result).
Bounds: the output and the aux loss within rtol = atol = 1e-5 (f32); the
capacity equal; the kept (token, choice) pairs and their slots equal to
the drop rule, stated here on its own in numpy (a stable sort by expert,
the slot in (token, choice) order, dropped past the capacity), at the
default capacity factor (with drops) and at 8.0 (none): where the kept
sets differed, a token's output would differ from the reference's by a
whole gated expert output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch import carry
from repro_torch.configs import registry as treg
from repro_torch.models import moe
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
WIDE = {"n_experts": 8, "top_k": 3}
CASES = [(arch, {}) for arch in ARCHS] + [("moonshot-v1-16b-a3b", WIDE)]


def _pair(arch, **replace):
    jcfg = dataclasses.replace(jreg.reduced(jreg.get(arch)), **replace)
    tcfg = dataclasses.replace(treg.reduced(treg.get(arch)), **replace)
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(5), jcfg))
    tparams = {k: carry._to_port(k, v, "moe") for k, v in params.items()}
    return jcfg, tcfg, params, tparams


def _tokens(params, cfg, b=2, s=24, seed=0):
    """Router inputs skewed towards expert 0, as a router that is out of
    balance sees them, so that the default capacity drops pairs."""
    lean = params["router"][:, 0] / np.linalg.norm(params["router"][:, 0])
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
    return (x + 3.0 * lean).astype(np.float32)


def _expected_dispatch(probs: np.ndarray, k: int, n_experts: int, cap: int):
    """The drop rule in numpy: (keep, slot) of each (token, choice) pair in
    pair order."""
    experts = np.argsort(-probs, axis=-1, kind="stable")[:, :k].reshape(-1)
    keep = np.zeros(experts.size, bool)
    slot = np.full(experts.size, n_experts * cap)
    seen = np.zeros(n_experts, int)
    for pair, e in enumerate(experts):
        if seen[e] < cap:
            keep[pair], slot[pair] = True, e * cap + seen[e]
        seen[e] += 1
    return keep, slot


@pytest.mark.parametrize("cf", [None, 8.0])
@pytest.mark.parametrize("arch,replace", CASES)
def test_moe_apply_matches_reference(arch, replace, cf):
    if cf is not None:
        replace = {**replace, "capacity_factor": cf}
    jcfg, tcfg, params, tparams = _pair(arch, **replace)
    x = _tokens(params, jcfg)
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(tcfg, t)
    assert cap == jmoe.capacity(jcfg, t)
    want, want_aux = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))

    route = moe.dispatch(tparams, tcfg, torch.from_numpy(x).reshape(t, -1),
                         cap)
    probs = route.probs.numpy()
    top = -np.sort(-probs, axis=-1)
    assert np.min(top[:, :tcfg.top_k] - top[:, 1:tcfg.top_k + 1]) > 1e-6
    keep, slot = _expected_dispatch(probs, tcfg.top_k, tcfg.n_experts, cap)
    order = route.order.numpy()
    np.testing.assert_array_equal(route.keep.numpy(), keep[order])
    np.testing.assert_array_equal(route.slot.numpy(), slot[order])
    assert np.all(np.diff(order[route.keep.numpy()]) != 0)
    # the default capacity drops pairs here, 8.0 drops none
    assert (keep.all() if cf == 8.0 else not keep.all())
    kept = route.slot.numpy()[route.keep.numpy()]
    assert len(set(kept)) == kept.size               # one pair a slot


@pytest.mark.parametrize("arch,replace", CASES)
def test_moe_init_matches_reference_shapes(arch, replace):
    jcfg, tcfg, params, _ = _pair(arch, **replace)
    got = moe.moe_init(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(params)
    for name, want in params.items():
        assert got[name].dtype == getattr(torch, str(want.dtype))
        want_shape = want.shape if name != "router" else want.shape[::-1]
        assert tuple(got[name].shape) == want_shape, name


def test_capacity_matches_reference():
    cfg_j = jreg.reduced(jreg.get("moonshot-v1-16b-a3b"))
    cfg_t = treg.reduced(treg.get("moonshot-v1-16b-a3b"))
    for cf in (1.0, 1.25, 1.1, 8.0):
        for e, k in ((4, 2), (64, 6), (384, 8)):
            rj = dataclasses.replace(cfg_j, capacity_factor=cf, n_experts=e,
                                     top_k=k)
            rt = dataclasses.replace(cfg_t, capacity_factor=cf, n_experts=e,
                                     top_k=k)
            for t in (1, 4, 7, 48, 128, 1000):
                assert moe.capacity(rt, t) == jmoe.capacity(rj, t), (cf, e,
                                                                     k, t)
