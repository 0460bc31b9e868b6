"""Rank bodies of the port's multi-process sharding tests (gloo ranks on
the CPU, started by :func:`repro_torch.testing.run_ranks`).  This module
imports neither JAX nor the reference, so the ranks start light; each
function returns numpy arrays, which go back to the test through a file.
"""
import numpy as np
import torch

ROUND_FIELDS = ("assignment", "barycenters", "counts", "new_center_idx",
                "theta", "med_d2")


def sketchers(inp):
    """The port's sketchers with the reference's maps injected."""
    from repro_torch.core import sketch as tsk

    dim = int(inp["sketch_dim"])
    return {"rproj": tsk.RProjSketcher(
                name="rproj", dim=dim,
                matrix=torch.from_numpy(inp["rproj_matrix"])),
            "countsketch": tsk.CountSketcher(
                name="countsketch", dim=dim,
                signs=torch.from_numpy(inp["countsketch_signs"]))}


def _whole(r, mesh, d):
    """A sharded round's fields, its barycenter and θ tiles gathered."""
    from repro_torch.core import sharded

    out = {f: getattr(r, f) for f in ROUND_FIELDS}
    out["theta"] = sharded.gather_cols(r.theta, mesh, d)
    out["barycenters"] = sharded.gather_cols(r.barycenters, mesh, d)
    return {f: v.numpy() for f, v in out.items()}


def rounds(rank, world, inp):
    """Every port base's sharded round (plain, weighted) and sketched
    rounds on this rank's tile; returns ``{case: fields}`` and the W passes
    each round counted on this rank."""
    from repro_torch.core import fused as tfz
    from repro_torch.core import instrument, sharded
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.parse_mesh(f"data={world}")
    w = torch.from_numpy(inp["w"])
    ci = torch.from_numpy(inp["center_idx"])
    cw = torch.from_numpy(inp["client_weights"])
    d = w.shape[1]
    out, passes = {}, {}
    for base in ("stream", "dot", "cuda"):
        sb = sharded.sharded_backend(base, mesh)
        cases = {"plain": {}, "weighted": {"client_weights": cw},
                 **{name: {"sketcher": sk}
                    for name, sk in sketchers(inp).items()}}
        for tag, kw in cases.items():
            with instrument.count_w_passes() as count:
                r = tfz.fused_round(w, ci, backend=sb, **kw)
            passes[f"{base}/{tag}"] = count()
            out[f"{base}/{tag}"] = _whole(r, mesh, d)
    return {"rounds": out, "passes": passes}


FED_D = 41            # odd: the tiles of P = 2 and 4 carry padding


def run_federation(case: str, mesh=None, store_dir=None, ckpt_dir=None):
    """A seeded federation of a linear model (D = 41) through the port's
    engine: ``case`` ``cohort`` (a 500-device fleet, cohorts of 5),
    ``semi_async`` (cellular-flaky) or ``hooks`` (scan with a snapshot
    and a checkpoint every round).  Returns θ and the trace's arrays."""
    from repro_torch import sim
    from repro_torch.core.client import ClientConfig
    from repro_torch.core.server import (TIMING_FIELDS, Federation,
                                         FederationConfig)
    from repro_torch.models.zoo import FLModel

    rng = np.random.default_rng(6)
    data = {"x": torch.from_numpy(
                rng.standard_normal((6, 32, FED_D)).astype(np.float32)),
            "y": torch.from_numpy(
                rng.standard_normal((6, 32)).astype(np.float32))}

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

    model = FLModel(name="linear", init=None, loss_fn=loss_fn,
                    accuracy=None, layout=(("w", "w", None),))
    kw = {"cohort": dict(fleet_size=500,
                         sim=sim.SimConfig(fleet="lognormal-edge")),
          "semi_async": dict(engine="semi_async",
                             sim=sim.SimConfig(fleet="cellular-flaky")),
          "hooks": {}}[case]
    n = 5 if case == "cohort" else 6
    cfg = FederationConfig(n_clients=n, n_coalitions=2, rounds=3,
                           client=ClientConfig(epochs=1, batch_size=8,
                                               lr=0.05),
                           mesh=mesh, **kw)
    fed = Federation(model, lambda p: -torch.sum(p["w"] ** 2), cfg)
    run_kw = {}
    if case == "hooks":
        from repro_torch.serve import ModelStore

        run_kw = dict(snapshot_every=1, store=ModelStore(store_dir),
                      ckpt_every=1, ckpt_dir=ckpt_dir)
    gp, hist = fed.run({"w": torch.zeros(FED_D)}, data,
                       generator=torch.Generator().manual_seed(10),
                       **run_kw)
    trace = {f: v for f, v in hist.trace._asdict().items()
             if v is not None and f not in TIMING_FIELDS}
    return {"theta": gp["w"].numpy(), "trace": trace,
            "backend": getattr(fed.strategy.backend, "name", None)}


def fl_round_case(inp, mesh=None, rank=0, world=1, wspec=None):
    """``make_fl_round_step`` on softmax-regression clients (the inputs'
    ``fl_*`` arrays), this rank's block of them under a mesh."""
    from repro_torch.core import coalitions
    from repro_torch.launch import steps

    def loss_fn(p, batch):
        logp = torch.log_softmax(batch["x"] @ p["w"] + p["b"], dim=-1)
        return -torch.mean(torch.gather(logp, 1, batch["y"][:, None]))

    w0 = torch.from_numpy(inp["fl_w"])
    template = {"b": torch.zeros(w0.shape[1]), "w": w0}
    fl_round = steps.make_fl_round_step(
        loss_fn, template, n_coalitions=int(inp["fl_k"]),
        lr=float(inp["fl_lr"]), local_steps=int(inp["fl_steps"]),
        shardmap_mesh=mesh, wspec=wspec)
    n = inp["fl_x"].shape[0]
    block = slice(rank * n // world, (rank + 1) * n // world)
    x = torch.from_numpy(inp["fl_x"])[block]
    y = torch.from_numpy(inp["fl_y"]).long()[block]
    cp = {k: v[None].expand(x.shape[0], *v.shape).clone()
          for k, v in template.items()}
    state = coalitions.CoalitionState(
        center_idx=torch.from_numpy(inp["fl_centers"]).long(), round=0)
    new, state, assignment, counts = fl_round(cp, {"x": x, "y": y}, state)
    return {"b": new["b"].numpy(), "w": new["w"].numpy(),
            "assignment": assignment.numpy(), "counts": counts.numpy(),
            "centers": state.center_idx.numpy()}


def job(rank, world, inp, parts, dirs=None):
    """The parts a test module asks of one spawn of ranks: ``rounds``,
    ``fl_round`` and federation cases (``fed:<case>``, ``dirs`` giving the
    hooks case its store and checkpoint directories)."""
    from repro_torch.launch import mesh as mesh_lib

    out = {}
    for part in parts:
        if part == "rounds":
            out[part] = rounds(rank, world, inp)
        elif part == "fl_round":
            out[part] = fl_round_case(
                inp, mesh=mesh_lib.parse_mesh(f"data={world}"), rank=rank,
                world=world)
        else:
            case = part.split(":")[1]
            out[part] = run_federation(case, mesh=f"data={world}",
                                       **(dirs or {}))
    return out


def moe_ep(rank, world, inp):
    """``moe_apply_ep`` on a (data=world, model=1) mesh, this rank's token
    block; its output, the aux loss, the drop count and its gradients'
    magnitudes (all ranks' parameters whole, sliced inside)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe

    cfg = dataclasses.replace(registry.reduced(registry.get(str(inp["arch"]))),
                              capacity_factor=float(inp["cf"]))
    mesh = mesh_lib.parse_mesh(f"data={world},model=1")
    params = {k: torch.from_numpy(inp[f"tparam/{k}"]).requires_grad_()
              for k in ("router", "wi_gate", "wi_up", "wo")}
    x = torch.from_numpy(inp["x"])
    block = x.shape[0] // world
    xl = x[rank * block:(rank + 1) * block].clone().requires_grad_()
    stats = {}
    out, aux = moe.moe_apply_ep(params, cfg, xl, mesh=mesh, stats=stats)
    (out.square().sum() + aux).backward()
    return {"out": out.detach().numpy(), "aux": float(aux),
            "dropped": stats["dropped"],
            "grads": {k: p.grad.numpy() for k, p in params.items()},
            "x_grad": xl.grad.numpy()}
