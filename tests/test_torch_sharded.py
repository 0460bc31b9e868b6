"""The port's sharding tier against the reference's, on the CPU.

* Mesh specs (``repro_torch.launch.mesh``): parsing and its errors (a
  ``data`` axis, integer sizes >= 1, no duplicate, the world's size), the
  production mesh's fallback with a RuntimeWarning, the canonical spec; a
  mesh built with no group running is gloo on a host with a card too.
* The sharded round (``repro_torch.core.sharded``) on a one-rank mesh
  against the port's dense round on ``stream``, ``dot`` and ``cuda`` (its
  kernels' plain versions here): bit for bit, with and without client
  weights; its sketched rounds equal in assignment and centers, θ within
  1e-5 of max; two W passes.
* At P = 2 and 4, gloo ranks on the CPU (``repro_torch.testing.run_ranks``)
  run every port base's sharded round (plain, weighted) and sketched round
  (rproj, countsketch, with the reference's maps injected) on their own
  column tiles of a clustered (16, 1001) W (odd D: the last tile carries
  zero columns); the reference's dense ``xla`` round and its sharded
  ``dot`` and ``pallas`` rounds (its sharded ``xla`` round does not run
  under this jax, ROADMAP C.3) run on the same numpy inputs in one JAX
  subprocess on four forced host devices (``tests/_sharded_reference.py``).
  Assignments, counts and centers equal (the clusters meet no tie, ROADMAP
  C.2); θ, barycenters and medoid distances within 1e-5 of their max; two
  W passes on every rank.
* Federations under ``mesh``: cohort mode, ``semi_async`` and the snapshot
  and checkpoint hooks, at one rank bit for bit and at two ranks against
  the dense run (θ within 1e-5 of max; equal cohorts and assignments; the
  published barycenters whole).
* ``make_fl_round_step`` against the reference's, in one process and over
  two ranks that each train half the clients.
* The CLI: ``--mesh data=1`` prints the reference's keys plus ``device``,
  ``mesh`` and ``backend_sharded``; a mesh of another size and ``--chunk
  0`` exit before any data loads; ``--chunk`` checks its consumers.
* ``launch.sharding``: the param, cache and batch specs of the ten archs
  at full size against the reference's, at a (16, 16) and a (2, 16, 16)
  mesh (the reference reads only a mesh's ``shape`` and ``axis_names``, so
  a stand-in serves); the port's names and shapes against a reduced model
  of each arch; DTensor placements.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
import types
import warnings
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import sketch as jsk
from repro.launch import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.core import fused as tfz
from repro_torch.core import instrument, sharded
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.testing import cap_cpu_threads, run_ranks

import _torch_sharded_ranks as ranks

cap_cpu_threads()

TOL = 1e-5
BASES = ("stream", "dot", "cuda")
CASES = ("plain", "weighted", "rproj", "countsketch")
#: the reference backend each port base is held to, beside the dense xla
REF_BASE = {"stream": "pallas", "dot": "dot", "cuda": "pallas"}
REF_SKETCH_BASE = {"stream": "xla", "dot": "dot", "cuda": "pallas"}
FED_CASES = ("cohort", "semi_async", "hooks")
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _inputs() -> dict:
    """16 clients in three well-separated clusters (5 / 5 / 6), D = 1001,
    client weights, the reference's sketch maps, and the FL round step's
    softmax-regression clients (seeded to give no two-member coalition,
    whose medoid rounding alone would pick)."""
    rng = np.random.default_rng(11)
    n, d, dim = 16, 1001, 64
    protos = np.array([-6.0, 0.0, 6.0])[:, None] * np.ones((3, d))
    owner = np.array([0] * 5 + [1] * 5 + [2] * 6)
    w = (protos[owner] + rng.standard_normal((n, d))).astype(np.float32)
    eye = jnp.eye(d, dtype=jnp.float32)
    rproj = np.asarray(jsk.sketch_block(jsk.make_sketcher("rproj", dim=dim),
                                        eye))
    counts = np.asarray(jsk.sketch_block(
        jsk.make_sketcher("countsketch", dim=dim), eye))
    fl = np.random.default_rng(2)
    return dict(
        w=w, center_idx=np.array([0, 5, 10]),
        client_weights=rng.uniform(0.5, 2.0, n).astype(np.float32),
        sketch_dim=dim,
        rproj_matrix=np.round(rproj * np.sqrt(dim)).astype(np.float32),
        countsketch_signs=counts[np.arange(d), np.arange(d) % dim],
        fl_x=fl.standard_normal((8, 12, 20)).astype(np.float32),
        fl_y=fl.integers(0, 5, (8, 12)),
        fl_w=(0.1 * fl.standard_normal((20, 5))).astype(np.float32),
        fl_k=3, fl_lr=0.1, fl_steps=2, fl_centers=np.array([0, 3, 6]))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The reference subprocess and the port's ranks, run side by side:
    {"ref": arrays, 2: rank results, 4: rank results, "dirs": hooks'}."""
    tmp = tmp_path_factory.mktemp("sharded")
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(src, **inputs)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_sharded_reference.py"),
         "rounds", src, dst], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        dirs = {"store_dir": str(tmp / "store2"), "ckpt_dir": str(tmp / "ck2")}
        out = {2: run_ranks(ranks.job, 2, inputs,
                            ["rounds", "fl_round"]
                            + [f"fed:{c}" for c in FED_CASES], dirs),
               4: run_ranks(ranks.job, 4, inputs, ["rounds"]),
               "dirs": dirs}
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    out["ref"] = dict(np.load(dst))
    return out


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _same_round(got: dict, ref: dict, prefix: str) -> None:
    for f in ("assignment", "new_center_idx"):
        np.testing.assert_array_equal(got[f], ref[f"{prefix}/{f}"], err_msg=f)
    np.testing.assert_allclose(got["counts"], ref[f"{prefix}/counts"],
                               rtol=1e-6)
    for f in ("theta", "barycenters", "med_d2"):
        _close(got[f], ref[f"{prefix}/{f}"])


# -- meshes -------------------------------------------------------------------

@pytest.mark.parametrize("spec,match", [
    ("data=x", "not an int"), ("data=0", ">= 1"), ("model=1", "'data'"),
    ("data=1,data=1", "duplicate"), ("data=2", "needs 2 ranks"),
    ("data=1,model=3", "torchrun --nproc-per-node 3"),
    ("bogus", "expected 'host'")])
def test_parse_mesh_errors(spec, match):
    with pytest.raises(ValueError, match=match):
        mesh_lib.parse_mesh(spec)
    with pytest.raises(ValueError, match=match):
        mesh_lib.check_spec(spec)


def test_parse_mesh_one_rank():
    m = mesh_lib.parse_mesh("data=1")
    assert mesh_lib.mesh_spec(m) == "data=1"
    assert mesh_lib.batch_axes(m) == ("data",)
    m2 = mesh_lib.parse_mesh(" data=1,model=1 ")
    assert mesh_lib.axis_sizes(m2) == {"data": 1, "model": 1}
    assert mesh_lib.mesh_spec(mesh_lib.parse_mesh("host")) == "data=1,model=1"
    assert mesh_lib.batch_axes({"pod": 2, "data": 16, "model": 16}) == \
        ("pod", "data")
    mesh_lib.check_spec("production")


def test_production_mesh_falls_back_with_warning():
    with pytest.warns(RuntimeWarning, match="fall"):
        m = mesh_lib.make_production_mesh()
    assert mesh_lib.mesh_spec(m) == "data=1,model=1"


_CPU_MESH_WITH_CARD = """
import torch
import torch.distributed as dist

# a host with a card, as the mesh module sees it
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
from repro_torch.core import fused
from repro_torch.core import sharded
from repro_torch.launch import mesh as mesh_lib

mesh = mesh_lib.parse_mesh("data=1")
assert dist.get_backend() == "gloo", dist.get_backend()
w = torch.randn((6, 37), generator=torch.Generator().manual_seed(0))
ci = torch.tensor([0, 3])
dense = fused.fused_round(w, ci, backend="cuda")
got = fused.fused_round(w, ci, backend=sharded.sharded_backend("cuda", mesh))
assert all(torch.equal(a, b) for a, b in zip(dense, got))
print("ok")
"""


def test_cpu_mesh_on_a_host_with_a_card():
    """A mesh built with no group running (as a Federation's is) starts
    gloo, which carries its CPU tiles, though the host has a card; a fresh
    process, so no group of another test is running."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _CPU_MESH_WITH_CARD],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sharded_backend_name_and_validation():
    mesh = mesh_lib.parse_mesh("data=1")
    assert sharded.sharded_backend("cuda", mesh).name == "cuda@data1"
    with pytest.raises(KeyError, match="unknown backend"):
        sharded.sharded_backend("nope", mesh)
    with pytest.raises(ValueError, match="has no 'model' axis"):
        sharded.sharded_backend("stream", mesh, axis="model")


# -- one rank: the dense round bit for bit ------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("base", BASES)
def test_one_rank_mesh_bitexact(inputs, base, weighted):
    mesh = mesh_lib.parse_mesh("data=1")
    w = torch.from_numpy(inputs["w"])
    ci = torch.from_numpy(inputs["center_idx"])
    kw = {"client_weights": torch.from_numpy(inputs["client_weights"])} \
        if weighted else {}
    dense = tfz.fused_round(w, ci, backend=base, **kw)
    with instrument.count_w_passes() as passes:
        got = tfz.fused_round(w, ci, backend=sharded.sharded_backend(
            base, mesh), **kw)
    assert passes() == 2
    for f in dense._fields:
        assert torch.equal(getattr(dense, f), getattr(got, f)), f


@pytest.mark.parametrize("name", ["rproj", "countsketch"])
@pytest.mark.parametrize("base", BASES)
def test_one_rank_mesh_sketched(inputs, base, name):
    mesh = mesh_lib.parse_mesh("data=1")
    sk = ranks.sketchers(inputs)[name]
    w = torch.from_numpy(inputs["w"])
    ci = torch.from_numpy(inputs["center_idx"])
    dense = tfz.fused_round(w, ci, backend=base, sketcher=sk)
    with instrument.count_w_passes() as passes:
        got = tfz.fused_round(w, ci, sketcher=sk,
                              backend=sharded.sharded_backend(base, mesh))
    assert passes() == 2
    for f in ("assignment", "counts", "new_center_idx"):
        assert torch.equal(getattr(dense, f), getattr(got, f)), f
    _close(got.theta, dense.theta)
    _close(got.med_d2, dense.med_d2)


# -- P = 2 and 4 gloo ranks against the reference --------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("p", [2, 4])
def test_ranks_match_reference(runs, p, base, case):
    ref = runs["ref"]
    got = runs[p][0]["rounds"]["rounds"][f"{base}/{case}"]
    if case in ("plain", "weighted"):
        _same_round(got, ref, f"P{p}/{REF_BASE[base]}/{case}")
        if base != "dot":
            _same_round(got, ref, f"dense/xla/{case}")
    else:
        _same_round(got, ref, f"P{p}/{REF_SKETCH_BASE[base]}/{case}")
        for f in ("assignment", "new_center_idx"):
            np.testing.assert_array_equal(got[f], ref[f"dense/xla/{case}/{f}"])


@pytest.mark.parametrize("p", [2, 4])
def test_ranks_two_passes_and_one_result(runs, p):
    results = [r["rounds"] for r in runs[p]]
    for res in results:
        assert set(res["passes"].values()) == {2}, res["passes"]
    for case, fields in results[0]["rounds"].items():
        for other in results[1:]:
            for f, v in fields.items():
                np.testing.assert_array_equal(v, other["rounds"][case][f],
                                              err_msg=f"{case} {f}")


# -- federations under a mesh ---------------------------------------------------

@pytest.mark.parametrize("case", FED_CASES)
def test_federation_one_rank_mesh_bitexact(case, tmp_path):
    dirs = {} if case != "hooks" else {"store_dir": str(tmp_path / "s"),
                                       "ckpt_dir": str(tmp_path / "c")}
    dense = ranks.run_federation(case, **dirs)
    dirs = {} if case != "hooks" else {"store_dir": str(tmp_path / "s1"),
                                       "ckpt_dir": str(tmp_path / "c1")}
    got = ranks.run_federation(case, mesh="data=1", **dirs)
    assert got["backend"] == "stream@data1"
    np.testing.assert_array_equal(got["theta"], dense["theta"])
    assert got["trace"].keys() == dense["trace"].keys()
    for f, v in dense["trace"].items():
        np.testing.assert_array_equal(got["trace"][f], v, err_msg=f)


@pytest.mark.parametrize("case", FED_CASES)
def test_federation_two_ranks(runs, case, tmp_path):
    dirs = {} if case != "hooks" else {"store_dir": str(tmp_path / "s"),
                                       "ckpt_dir": str(tmp_path / "c")}
    dense = ranks.run_federation(case, **dirs)
    for got in (r[f"fed:{case}"] for r in runs[2]):
        assert got["backend"] == "stream@data2"
        _close(got["theta"], dense["theta"])
        for f in ("assignment", "cohort", "participation"):
            if f in dense["trace"]:
                np.testing.assert_array_equal(got["trace"][f],
                                              dense["trace"][f], err_msg=f)
        _close(got["trace"]["drift"], dense["trace"]["drift"])
    if case == "hooks":
        from repro_torch.checkpoint import checkpoint
        from repro_torch.serve import ModelStore

        mine, want = (ModelStore(runs["dirs"]["store_dir"]),
                      ModelStore(dirs["store_dir"]))
        assert mine.rounds() == want.rounds() == [0, 1, 2]
        for r in want.rounds():
            _close(mine.load(r).barycenters, want.load(r).barycenters)
        assert checkpoint.available_steps(runs["dirs"]["ckpt_dir"]) == \
            [0, 1, 2]


# -- make_fl_round_step ----------------------------------------------------------

def test_fl_round_step_matches_reference(runs, inputs):
    ref = runs["ref"]
    got = ranks.fl_round_case(inputs)
    blocks = [r["fl_round"] for r in runs[2]]
    two = {k: np.concatenate([b[k] for b in blocks]) for k in ("b", "w")}
    for out in (got, *blocks):
        for f in ("assignment", "counts", "centers"):
            np.testing.assert_array_equal(out[f], ref[f"fl/{f}"], err_msg=f)
    for out in (got, two):
        for f in ("b", "w"):
            _close(out[f], ref[f"fl/{f}"])


def test_fl_round_step_one_rank_mesh_is_dense(inputs):
    """Over a one-rank mesh, with the matrix's columns named by ``wspec``,
    the step equals the one without a mesh bit for bit."""
    mesh = mesh_lib.parse_mesh("data=1")
    dense = ranks.fl_round_case(inputs)
    for wspec in (None, (None, "data")):
        got = ranks.fl_round_case(inputs, mesh=mesh, wspec=wspec)
        for f, v in dense.items():
            np.testing.assert_array_equal(got[f], v, err_msg=f)


# -- the CLI ----------------------------------------------------------------------

CLI = ["--mode", "fl", "--device", "cpu", "--rounds", "2", "--clients", "6",
       "--coalitions", "2", "--local-epochs", "1", "--n-train", "600",
       "--n-test", "200"]


def test_cli_mesh_keys():
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = ttrain.main(CLI + ["--mesh", "data=1"])
    printed = json.loads(buf.getvalue())
    assert printed["mesh"] == "data=1"
    assert printed["backend_sharded"] == "cuda@data1"
    assert printed["device"] == "cpu"
    with redirect_stdout(io.StringIO()):
        dense = ttrain.main(CLI)
    assert out["test_acc"] == dense["test_acc"]
    want = {"mode", "method", "engine", "model", "sketch", "regime",
            "scenario", "rho", "scenario_spearman", "source",
            "strategy_extras", "test_acc", "train_loss", "final_assignment",
            "final_counts", "mean_churn", "final_entropy", "mean_drift",
            "wall_s", "device", "mesh", "backend_sharded"}
    assert set(printed) == want


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "data=3"], "--mesh: mesh 'data=3' needs 3 ranks"),
    (["--mesh", "model=1"], "a 'data' axis is required"),
    (["--chunk", "0"], "chunk must be >= 1, got 0"),
    (["--chunk", "64", "--method", "fedavg"], "--chunk applies only to")])
def test_cli_fails_before_data(flags, match, monkeypatch):
    from repro_torch.data import synthetic

    def no_data(*a, **k):
        raise AssertionError("data was loaded")

    monkeypatch.setattr(synthetic, "mnist_idx", no_data)
    monkeypatch.setattr(synthetic, "digits", no_data)
    with pytest.raises(SystemExit, match=match):
        ttrain.main(CLI + flags)


def test_cli_chunk_consumed():
    with redirect_stdout(io.StringIO()):
        out = ttrain.main(CLI + ["--backend", "stream", "--chunk", "4096"])
        dense = ttrain.main(CLI + ["--backend", "stream"])
    assert out["strategy_extras"] == {"chunk": 4096}
    assert out["final_assignment"] == dense["final_assignment"]
    np.testing.assert_allclose(out["test_acc"], dense["test_acc"], atol=0.01)


# -- sharding specs against the reference -----------------------------------------

MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}
ARCHS = list(treg.ASSIGNED)


def _stand_in(sizes):
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _ref_tree(arch):
    cfg = jreg.get(arch)
    return jax.eval_shape(lambda: jtf.init(jax.random.key(0), cfg))


def _port_view(tree):
    """The reference's leaves as the port names and lays them out: one
    per-layer name (layer 0) for each stacked leaf, without its L axis,
    dense weights transposed.  Yields (port name, ref path, port shape,
    stacked?, dense?)."""
    from repro_torch import carry

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        ref_path = "/".join(keys)
        lead = ref_path.startswith(("layers/", "encoder/layers/"))
        shape = tuple(leaf.shape)[1:] if lead else tuple(leaf.shape)
        parent = keys[-2] if len(keys) > 1 else ""
        dense = len(shape) == 2 and carry._dense(parent, keys[-1])
        names = list(keys)
        if lead:
            names.insert(keys.index("layers") + 1, "0")
        yield (".".join(names), ref_path, shape[::-1] if dense else shape,
               lead, dense)


def _ref_spec_as_port(spec, ndim, lead, dense):
    full = tuple(spec) + (None,) * (ndim + lead - len(tuple(spec)))
    full = full[1:] if lead else full
    return full[::-1] if dense else full


@pytest.mark.parametrize("moe_axis", ["data", "model"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, moe_axis):
    sizes = MESHES[mesh]
    tree = _ref_tree(arch)
    ref = jsharding.param_specs(_stand_in(sizes), tree,
                                moe_expert_axis=moe_axis)
    ref_by_path = {jsharding._path_str(p): s for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       ref, is_leaf=lambda x: isinstance(
                           x, jax.sharding.PartitionSpec))[0]}
    view = list(_port_view(tree))
    got = sharding.param_specs(sizes, {n: s for n, _, s, _, _ in view},
                               moe_expert_axis=moe_axis)
    for name, ref_path, shape, lead, dense in view:
        assert got[name] == _ref_spec_as_port(ref_by_path[ref_path],
                                              len(shape), lead, dense), name


@pytest.mark.parametrize("arch", ARCHS)
def test_port_names_and_shapes_are_the_models(arch):
    """The view the spec test builds is the port model's own: every name
    and shape of a reduced model of the arch (layer 0 for the stacks)."""
    cfg = treg.reduced(treg.get(arch))
    model = ttf.init(torch.Generator().manual_seed(0), cfg)
    mine = {n: tuple(p.shape) for n, p in model.named_parameters()
            if ".layers." not in f".{n}" or ".0." in f".{n}."}
    jcfg = jreg.reduced(jreg.get(arch))
    tree = jax.eval_shape(lambda: jtf.init(jax.random.key(0), jcfg))
    view = {n: s for n, _, s, _, _ in _port_view(tree)}
    assert view == mine


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    cfg = jreg.get(arch)
    for batch, max_len in ((64, 2048), (1, 4096)):
        cache = jax.eval_shape(lambda: jtf.init_cache(cfg, batch, max_len))
        ref = jsharding.cache_specs(_stand_in(sizes), cache)
        got = sharding.cache_specs(sizes, {k: v.shape
                                           for k, v in cache.items()})
        assert got == {k: tuple(v) for k, v in ref.items()}, (batch, arch)
        shapes = {"tokens": (batch, 128), "modal": (batch, 16, 32),
                  "step": ()}
        ref = jsharding.batch_specs(_stand_in(sizes), {
            k: jax.ShapeDtypeStruct(s, jnp.float32)
            for k, s in shapes.items()})
        got = sharding.batch_specs(sizes, shapes)
        assert got == {k: tuple(v) for k, v in ref.items()}


def test_round_specs_match_reference():
    assert sharding.cohort_matrix_spec() == tuple(
        jsharding.cohort_matrix_spec())
    got = sharding.fused_stats_specs("data")
    want = jsharding.fused_stats_specs("data")
    assert tuple(got) == tuple(tuple(s) for s in want)


def test_opt_state_specs_shard_like_params():
    sizes = MESHES["pod1"]
    params = {"layers.0.attn.wq": (4096, 4096), "ln_f.scale": (4096,)}
    state = {"step": (), "m": params, "v": params}
    got = sharding.opt_state_specs(sizes, state)
    want = sharding.param_specs(sizes, params)
    assert got == {"step": (), "m": want, "v": want}


def test_with_named_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_lib.parse_mesh("data=1,model=1")
    specs = {"a": ("model", None), "b": (("pod", "data"),), "c": {"d": ()}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sharding.with_named(mesh, {"a": specs["a"], "c": specs["c"]})
    assert got == {"a": [Replicate(), Shard(0)],
                   "c": {"d": [Replicate(), Replicate()]}}
    assert sharding.placements(
        mesh_lib.parse_mesh("data=1"), ("data", None)) == [Shard(0)]
    del specs


def test_dtensor_train_step_matches_plain():
    """A reduced starcoder2's train step with its parameters placed as
    DTensors by the specs at world 1 (every placement trivial) equals the
    plain step."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import steps

    cfg = treg.reduced(treg.get("starcoder2-7b"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)))
    mesh = mesh_lib.parse_mesh("data=1,model=1")
    losses = []
    for place in (False, True):
        model = ttf.init(torch.Generator().manual_seed(0), cfg)
        if place:
            specs = sharding.param_specs(mesh, dict(model.named_parameters()))
            for name, p in list(model.named_parameters()):
                mod_name, _, leaf = name.rpartition(".")
                mod = model.get_submodule(mod_name) if mod_name else model
                dt = distribute_tensor(p.detach(), mesh,
                                       sharding.placements(mesh, specs[name]))
                setattr(mod, leaf, torch.nn.Parameter(dt))
        step, opt = steps.make_train_step(cfg, optimizer="adam", lr=1e-3,
                                          remat=False)
        state = opt.init(dict(model.named_parameters()))
        with implicit_replication():
            for _ in range(2):
                loss = step(model, state, {"tokens": toks})
                losses.append(float(loss.full_tensor() if hasattr(
                    loss, "full_tensor") else loss))
    plain, placed = losses[:2], losses[2:]
    np.testing.assert_allclose(placed, plain, rtol=1e-6)
