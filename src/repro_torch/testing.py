"""Helpers for the port's test processes.

:func:`cap_cpu_threads` keeps parallel test workers from oversubscribing the
host: each pytest-xdist worker would otherwise start torch's default number
of intra-op threads (one per core), so six workers on eight cores run 48
busy threads and a test that takes seconds alone takes minutes.
"""
from __future__ import annotations

import contextlib
import os

import torch


def cap_cpu_threads() -> int:
    """Cap torch's intra-op and inter-op threads at the host's cores shared
    out over the xdist workers (``PYTEST_XDIST_WORKER_COUNT``), at least 1.

    The inter-op pool can be sized only once per process and only before
    it first runs, so a second call (another test file in the same worker)
    leaves it as it is.  ``OMP_NUM_THREADS`` is set as well, so processes
    the tests start inherit the cap.  Returns the thread count.
    """
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // max(workers, 1))
    os.environ["OMP_NUM_THREADS"] = str(n)
    torch.set_num_threads(n)
    try:
        torch.set_num_interop_threads(n)
    except RuntimeError:     # already set, or the pool has already run
        pass
    return n


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with ``n`` intra-op threads, then restore the count:
    for a test whose floating-point result depends on how CPU kernels
    split their sums over threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _rank_entry(fn, rank: int, world: int, store: str, out_dir: str,
                device: str, args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device: str = "cpu",
              timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in a gloo process group over a ``file://`` store, with one intra-op
    thread each (ranks that share ``device``: a card, or the CPU), and
    return each rank's result in rank order (``torch.save``-able; it goes
    back through a file).  ``fn`` must be importable by the children.
    Raises if a rank fails or is still running after ``timeout`` seconds,
    which then ends every rank."""
    import tempfile
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-torch-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, world, store, tmp, device, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.kill()
                p.join()
        if late:
            raise TimeoutError(f"{len(late)} of {world} ranks still ran "
                               f"after {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def sharded_toy_flops(hidden: int, device: str = "cpu") -> dict:
    """Count a two-layer MLP's forward (batch 32, width 64, ``hidden``
    wide) unsharded, then per rank on a (4, 4) fake mesh, the batch over
    ``data`` and the hidden dim over ``model`` where the model axis divides
    it (else the weights replicate, by the sharding rules' ``_fit``), on
    stand-ins of ``device`` type.  Where every dim divides, a rank counts
    1/16 of the unsharded FLOPs: a check that the counter sees the
    rank-local ops and not DTensor's shape propagation.  Starts (or
    restarts) the default process group as a fake one of 16 ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import analysis, dryrun, sharding

    batch, d = 32, 64
    sizes = {"data": 4, "model": 4}
    mesh = dryrun.fake_mesh(sizes, device)
    specs = {"x": ("data", None),
             "w1": (None, sharding._fit(sizes, hidden, "model")),
             "w2": (sharding._fit(sizes, hidden, "model"), None)}

    def fwd(x, w1, w2):
        return torch.relu(x @ w1) @ w2

    with FakeTensorMode():
        tensors = {"x": torch.empty(batch, d, device=device),
                   "w1": torch.empty(d, hidden, device=device),
                   "w2": torch.empty(hidden, d, device=device)}
        whole = analysis.Counter()
        with whole:
            fwd(**tensors)
        placed = sharding.attach(specs, tensors, mesh)
        rank = analysis.Counter()
        with dryrun.counted_step(rank):
            fwd(**placed)
    roof = analysis.roofline(rank, chips=16, model_flops_global=whole.flops)
    return {"hidden": hidden, "global_flops": whole.flops,
            "rank_flops": rank.flops, "useful_ratio": roof["useful_ratio"],
            "collectives": rank.collectives}


def ssm_chunk_loop(delta, u, bmat, cmat, a, h0, chunk: int):
    """The SSM scan without its operator: the chunk loop as ``ssm_apply``
    ran it inline, each chunk under ``torch.utils.checkpoint`` while
    gradients are on, so autograd differentiates the steps' own ops.  The
    plain version that ``torch.ops.repro_torch.ssm_scan`` and its backward
    are held to.  Returns (y, h_last)."""
    import math

    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.ssm_scan import _chunk

    s = delta.shape[1]
    chunk = min(chunk, s)
    sp = math.ceil(s / chunk) * chunk
    pads = [F.pad(t, (0, 0, 0, sp - s)) for t in (delta, bmat, cmat, u)]
    h, ys = h0, []
    for c0 in range(0, sp, chunk):
        args = [t[:, c0:c0 + chunk] for t in pads]
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk, h, *args, a, use_reentrant=False)
        else:
            h, y = _chunk(h, *args, a)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h
