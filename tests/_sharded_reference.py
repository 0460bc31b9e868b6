"""The reference's sharded rounds, MoE expert parallelism and FL round step
on forced host devices, for the port's parity tests.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_sharded_reference.py MODE INPUTS.npz OUT.npz

MODE ``rounds``: for P in (2, 4) the reference's sharded ``dot`` and
``pallas`` rounds (its sharded ``xla`` round does not run under this jax:
its scan carry has no varying mesh axis) with and without client weights,
and its sharded sketched rounds (rproj, countsketch) on ``xla``, ``dot``
and ``pallas``; the dense ``xla`` round and the dense sketched ``xla``
rounds; and ``make_fl_round_step`` without a mesh.  MODE ``moe``:
``moe_apply_ep`` on a (data=2, model=1) mesh and the one-device
``moe_apply``.  Every result goes into OUT as ``<case>/<field>`` arrays.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROUND_FIELDS = ("assignment", "barycenters", "counts", "new_center_idx",
                "theta", "med_d2")


def _round_out(out, prefix, r):
    for f in ROUND_FIELDS:
        out[f"{prefix}/{f}"] = np.asarray(getattr(r, f))


def rounds(inp, out):
    from repro.core import fused as fz
    from repro.core import sharded
    from repro.core import sketch as jsk
    from repro.launch import mesh as mesh_lib

    w = jnp.asarray(inp["w"])
    ci = jnp.asarray(inp["center_idx"], jnp.int32)
    cw = jnp.asarray(inp["client_weights"])
    dim = int(inp["sketch_dim"])

    def run(backend, **kw):
        # jitted: eager shard_map dispatches op by op, ~10x slower here
        return jax.jit(lambda w_: fz.fused_round(w_, ci, backend=backend,
                                                 **kw))(w)

    meshes = {p: mesh_lib.parse_mesh(f"data={p}") for p in (2, 4)}
    for tag, kw in (("plain", {}), ("weighted", {"client_weights": cw})):
        _round_out(out, f"dense/xla/{tag}", run("xla", **kw))
        for p, mesh in meshes.items():
            for base in ("dot", "pallas"):
                _round_out(out, f"P{p}/{base}/{tag}",
                           run(sharded.sharded_backend(base, mesh), **kw))
    for name in ("rproj", "countsketch"):
        sk = jsk.make_sketcher(name, dim=dim)
        _round_out(out, f"dense/xla/{name}", run("xla", sketcher=sk))
        for p, mesh in meshes.items():
            for base in ("xla", "dot", "pallas"):
                _round_out(out, f"P{p}/{base}/{name}",
                           run(sharded.sharded_backend(base, mesh),
                               sketcher=sk))
    fl_round_step(inp, out)


def fl_round_step(inp, out):
    """The reference's one-program FL round: softmax regression clients."""
    from repro.core import coalitions
    from repro.launch import steps

    def loss_fn(p, batch):
        logp = jax.nn.log_softmax(batch["x"] @ p["w"] + p["b"])
        return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None], 1))

    n = inp["fl_x"].shape[0]
    template = {"b": jnp.zeros((inp["fl_w"].shape[1],)),
                "w": jnp.asarray(inp["fl_w"])}
    fl_round = steps.make_fl_round_step(
        loss_fn, template, n_coalitions=int(inp["fl_k"]),
        lr=float(inp["fl_lr"]), local_steps=int(inp["fl_steps"]))
    cp = jax.tree.map(lambda l: jnp.broadcast_to(l[None], (n,) + l.shape),
                      template)
    batch = {"x": jnp.asarray(inp["fl_x"]), "y": jnp.asarray(inp["fl_y"])}
    state = coalitions.CoalitionState(
        center_idx=jnp.asarray(inp["fl_centers"], jnp.int32),
        round=jnp.int32(0))
    new, state, assignment, counts = fl_round(cp, batch, state)
    out["fl/b"] = np.asarray(new["b"])
    out["fl/w"] = np.asarray(new["w"])
    out["fl/assignment"] = np.asarray(assignment)
    out["fl/counts"] = np.asarray(counts)
    out["fl/centers"] = np.asarray(state.center_idx)


def moe(inp, out):
    from jax.sharding import Mesh

    from repro.configs import registry
    from repro.models import moe as jmoe

    cfg = dataclasses.replace(registry.reduced(registry.get(str(inp["arch"]))),
                              capacity_factor=float(inp["cf"]))
    params = {k: jnp.asarray(inp[f"param/{k}"])
              for k in ("router", "wi_gate", "wi_up", "wo")}
    x = jnp.asarray(inp["x"])
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ("data", "model"))
    with mesh:
        got, aux = jax.jit(lambda p, x_: jmoe.moe_apply_ep(
            p, cfg, x_, mesh=mesh))(params, x)
    out["ep/out"], out["ep/aux"] = np.asarray(got), np.asarray(aux)
    dense, daux = jmoe.moe_apply(params, cfg, x)
    out["dense/out"], out["dense/aux"] = np.asarray(dense), np.asarray(daux)


if __name__ == "__main__":
    mode, src, dst = sys.argv[1:4]
    inputs = dict(np.load(src))
    results: dict = {}
    {"rounds": rounds, "moe": moe}[mode](inputs, results)
    np.savez(dst, **results)
