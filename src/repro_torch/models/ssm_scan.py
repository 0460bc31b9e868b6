"""The Mamba-1 selective scan as one registered operator,
``torch.ops.repro_torch.ssm_scan``, with its backward
``torch.ops.repro_torch.ssm_scan_backward``.

The reference's scan is one ``lax.scan`` over chunks whose body is a
``lax.scan`` over steps (``repro.models.ssm.ssm_apply``), which XLA lowers
and costs once.  The port's body is a Python loop (:func:`_chunk`: one
``addcmul`` and one batched product a step); as an operator it is one op
to autograd, to ``FakeTensorMode`` (:func:`_scan_fake`), to DTensor (the
rules in :mod:`repro_torch.launch.sharding`) and to the dry-run's counter
(:func:`forward_cost`, :func:`backward_cost`), so a traced layer holds one
scan op, not L x S dispatches.

The operator has no kernel of its own: its body is the plain loop on every
device, a CUDA tensor included, so there is nothing to fall back from.  On
the CPU its ``y`` and ``h_last`` are the chunk loop's bit for bit.

Forward: ``ssm_scan(delta, u, bmat, cmat, a, h0, chunk, save)`` with delta,
u (B, S, di) f32, bmat, cmat (B, S, N) f32, a (di, N) f32, h0 (B, di, N)
f32 -> ``y`` (B, S, di), ``h_last`` (B, di, N) and the carry at each
chunk's start (B, ceil(S / chunk), di, N), which the reference's
``jax.checkpoint`` over its outer scan keeps as residuals; with ``save``
False (no backward to come, as in a prefill) the carries are an empty
(B, 0, di, N) and cost nothing.  The tail is padded to a whole chunk with
delta = 0, whose steps leave h unchanged.

Backward: the chunks in reverse, each chunk's states recomputed from its
saved carry, then the reverse recurrence

    gh_t = gh_{t+1}·da_{t+1} + gy_t ⊗ c_t,   gc_t = Σ_d h_t·gy_t,
    gda_t = gh_t·h_{t-1},                     gdbu_t = gh_t,

and from ``da = exp(δ·a)``, ``dbu = δ·u·b`` the gradients of delta, u,
bmat, a and h0.  A custom op's body builds no autograd graph, so the
reverse scan is written out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _chunk(h, dl, bm, cm, uu, a):
    """One chunk of the recurrence.  h (B, di, N); dl, uu (B, L, di); bm, cm
    (B, L, N); a (di, N).  Returns the last h and y (B, L, di).  The steps'
    slices come from ``unbind``, whose backward is one stack: indexing
    ``da[:, t]`` instead would make autograd fill and add a full
    (B, L, di, N) gradient for every step (autograd runs through it in
    :func:`repro_torch.testing.ssm_chunk_loop`, the plain version)."""
    da = torch.exp(dl[..., None] * a)                          # (B, L, di, N)
    dbu = (dl * uu)[..., None] * bm[..., None, :]              # (B, L, di, N)
    ys = []
    for da_t, dbu_t, c_t in zip(da.unbind(1), dbu.unbind(1),
                                cm[..., None].unbind(1)):
        h = torch.addcmul(dbu_t, h, da_t)
        ys.append(torch.bmm(h, c_t)[..., 0])
    return h, torch.stack(ys, dim=1)


def _layout(s: int, chunk: int) -> tuple[int, int, int]:
    """(chunk length, number of chunks, steps kept of the last chunk)."""
    chunk = min(chunk, s)
    nc = math.ceil(s / chunk)
    return chunk, nc, s - (nc - 1) * chunk


def scan_forward(delta, u, bmat, cmat, a, h0, chunk: int, save: bool):
    """The forward op's body: :func:`_chunk` chunk after chunk over the
    padded sequence."""
    b, s, di = delta.shape
    chunk, nc, keep = _layout(s, chunk)
    pads = [F.pad(t, (0, 0, 0, nc * chunk - s))
            for t in (delta, bmat, cmat, u)]
    h, ys, carries = h0, [], []
    for c0 in range(0, nc * chunk, chunk):
        if save:
            carries.append(h)
        h, y = _chunk(h, *[t[:, c0:c0 + chunk] for t in pads], a)
        ys.append(y)
    ys[-1] = ys[-1][:, :keep]
    carry = (torch.stack(carries, dim=1) if save
             else h0.new_empty((b, 0, di, h0.shape[-1])))
    return torch.cat(ys, dim=1), h, carry


def _chunk_backward(g, h, dl, bm, cm, uu, gy, a):
    """One chunk of the backward, step-major: dl, uu, gy (L, B, di); bm, cm
    (L, B, N), contiguous; h the chunk's carry and g the gradient of its
    last state, (B, di, N).  Returns the gradient of the carry, the
    chunk's (gdelta, gu) (L, B, di) and (gb, gc) (L, B, N), and its share
    of ga (di, N)."""
    l, b, di = dl.shape
    n = a.shape[1]
    da = torch.exp(dl[..., None] * a)                          # (L, B, di, N)
    su = dl * uu
    dbu = su[..., None] * bm[..., None, :]
    hs = h.new_empty((l + 1, b, di, n))              # h_{-1} .. h_{L-1}
    hs[0] = h
    for t in range(l):
        torch.addcmul(dbu[t], hs[t], da[t], out=hs[t + 1])
    del dbu
    gh = torch.empty_like(da)
    for t in reversed(range(l)):
        torch.addcmul(g, gy[t, :, :, None], cm[t, :, None, :], out=gh[t])
        g = gh[t] * da[t]
    gc = torch.bmm(gy.view(l * b, 1, di), hs[1:].view(l * b, di, n))
    gs = torch.bmm(gh.view(l * b, di, n), bm.view(l * b, n, 1))
    gb = torch.bmm(su.view(l * b, 1, di), gh.view(l * b, di, n))
    gx = gh.mul_(hs[:-1]).mul_(da)                             # d exponent
    del hs, da
    gs = gs.view(l, b, di)
    gdl = torch.addcmul((gx * a).sum(-1), gs, uu)
    ga = (gx * dl[..., None]).sum((0, 1))
    return g, (gdl, gs * dl, gb.view(l, b, n), gc.view(l, b, n)), ga


def scan_backward(gy, gh, delta, u, bmat, cmat, a, carries, chunk: int):
    """The backward op's body: :func:`_chunk_backward` over the chunks in
    reverse from their saved carries.  Returns the gradients of delta, u,
    bmat, cmat, a and h0."""
    s = delta.shape[1]
    chunk, nc, keep = _layout(s, chunk)
    if carries.shape[1] != nc:
        raise RuntimeError("ssm_scan_backward needs the carries of a forward "
                           "run with save=True")
    pads = [F.pad(t, (0, 0, 0, nc * chunk - s))
            for t in (delta, bmat, cmat, u, gy)]
    g, ga, parts = gh, None, []
    for c in reversed(range(nc)):
        steps = [t[:, c * chunk:(c + 1) * chunk].transpose(0, 1).clone(
            memory_format=torch.contiguous_format) for t in pads]
        g, part, ga_c = _chunk_backward(g, carries[:, c], *steps, a)
        ga = ga_c if ga is None else ga + ga_c
        parts.append(part)
        del steps, ga_c
    parts.reverse()
    grads = [torch.cat([p[i].transpose(0, 1) for p in parts[:-1]]
                       + [parts[-1][i][:keep].transpose(0, 1)], dim=1)
             for i in range(4)]
    gdl, gu, gb, gc = grads
    return gdl, gu, gb, gc, ga, g


# The counts of the two ops for the dry-run's counter
# (repro_torch.launch.analysis.Counter).  FLOPs: what torch's flop registry
# counts for the chunk loop run inline under autograd (only the step
# products count): 2 a state element and step forward; backward, the
# products' two gradients (4) and the chunk's recompute under
# torch.utils.checkpoint, which stops before its last step's product (its
# output is not needed), so 6·B·Sp·di·N less 2·B·di·N a chunk.  Bytes and
# peak: the bodies' eager ops as the counter counts them (each op's input
# and output bytes, an ``out=`` tensor read and written; the peak of the
# live bytes over the inputs').  In elements: E = B·L·di·N (a chunk's
# (B, L, di, N) tensor), P = B·L·di, Q = B·L·N, H = B·di·N, A = di·N;
# every tensor f32.  The tests hold the FLOPs against a counter run of the
# inline loop and the bytes and peak against one of the bodies.

def _sizes(delta, a, chunk: int):
    b, s, di = delta.shape
    n = a.shape[1]
    chunk, nc, _ = _layout(s, chunk)
    return (b, s, di, n, chunk, nc, nc * chunk, b * chunk * di * n,
            b * chunk * di, b * chunk * n, b * di * n, di * n)


def forward_cost(delta, u, bmat, cmat, a, h0, chunk: int, save: bool
                 ) -> tuple[int, int, int]:
    """(FLOPs, bytes, peak bytes) of :func:`scan_forward` on these
    inputs: per chunk the (B, L, di, N) ``da`` and ``dbu`` (four
    elementwise ops), two ops a step and the stack of the chunk's y; the
    padding, the carries' stack and the final concatenation around it."""
    b, s, di, n, l, nc, sp, e, p, q, h, an = _sizes(delta, a, chunk)
    pads = b * sp * (2 * di + 2 * n)
    nbytes = (b * (s + sp) * (2 * di + 2 * n)
              + nc * (9 * e + 8 * p + 2 * q + an)
              + 2 * nc * h * save + 2 * b * s * di)
    carried = (nc - 1) * h if save else min(nc - 1, 1) * h
    # in the last chunk, beside its da and dbu: its last step (two states)
    # or the stack of its y; or the end
    step = max(2 * p + h, p - b * di + (1 + (l > 1)) * h)
    peak = max(pads + (nc - 1) * p + 2 * e + carried + step,
               pads + nc * p + h + (2 * nc - 1) * h * save + b * s * di)
    es = delta.element_size()
    return 2 * b * sp * di * n, es * nbytes, es * peak


def backward_cost(gy, gh, delta, u, bmat, cmat, a, carries, chunk: int
                  ) -> tuple[int, int, int]:
    """(FLOPs, bytes, peak bytes) of :func:`scan_backward` on these
    inputs: per chunk the step-major copies of its five inputs, ``da``,
    ``dbu``, the recomputed states, the reverse loop, three batched
    products (gc, gs, gb) and the elementwise gradient ops; the padding, the
    ga sum and the four concatenations around it."""
    b, s, di, n, l, nc, sp, e, p, q, h, an = _sizes(delta, a, chunk)
    pads = b * sp * (3 * di + 2 * n)
    nbytes = (b * (s + sp) * (3 * di + 2 * n)
              + nc * (30 * e + 3 * h + 24 * p + 9 * q + 3 * an)
              + 3 * (nc - 1) * an + 4 * b * s * (di + n))
    # in the last chunk, after nc - 1 chunks' gradients and beside its da,
    # gh and the states: its reverse loop (two gradient states) or its
    # three products; or the end
    last = max(h + p + 2 * q, (1 + (l > 1)) * h)
    peak = max(pads + (3 * p + 2 * q) + (nc - 1) * (2 * p + 2 * q)
               + (nc > 1) * (an + h) + 3 * e + h + p + last,
               pads + nc * (2 * p + 2 * q) + an + h + b * s * (2 * di + 2 * n))
    es = delta.element_size()
    return 6 * b * sp * di * n - 2 * nc * h, es * nbytes, es * peak


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def ssm_scan(delta: Tensor, u: Tensor, bmat: Tensor, cmat: Tensor, a: Tensor,
             h0: Tensor, chunk: int, save: bool
             ) -> tuple[Tensor, Tensor, Tensor]:
    """The selective scan (module docstring): y, h_last, carries.  The
    plain chunk loop on every device; no kernel."""
    return scan_forward(delta, u, bmat, cmat, a, h0, chunk, save)


@ssm_scan.register_fake
def _scan_fake(delta, u, bmat, cmat, a, h0, chunk, save):
    b, s, di = delta.shape
    nc = _layout(s, chunk)[1] if save else 0
    return (delta.new_empty((b, s, di)), h0.new_empty(h0.shape),
            h0.new_empty((b, nc, di, h0.shape[-1])))


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=())
def ssm_scan_backward(gy: Tensor, gh: Tensor, delta: Tensor, u: Tensor,
                      bmat: Tensor, cmat: Tensor, a: Tensor, carries: Tensor,
                      chunk: int) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                           Tensor, Tensor]:
    """The scan's backward (module docstring): the gradients of delta, u,
    bmat, cmat, a and h0.  The plain reverse loop on every device."""
    return scan_backward(gy, gh, delta, u, bmat, cmat, a, carries, chunk)


@ssm_scan_backward.register_fake
def _scan_backward_fake(gy, gh, delta, u, bmat, cmat, a, carries, chunk):
    return (delta.new_empty(delta.shape), u.new_empty(u.shape),
            bmat.new_empty(bmat.shape), cmat.new_empty(cmat.shape),
            a.new_empty(a.shape), gh.new_empty(gh.shape))


def _setup_context(ctx, inputs, output):
    delta, u, bmat, cmat, a, _h0, chunk, _save = inputs
    ctx.save_for_backward(delta, u, bmat, cmat, a, output[2])
    ctx.chunk = chunk
    ctx.mark_non_differentiable(output[2])


def _backward(ctx, gy, gh, _gcarries):
    grads = ssm_scan_backward(gy, gh, *ctx.saved_tensors, ctx.chunk)
    return (*grads, None, None)


ssm_scan.register_autograd(_backward, setup_context=_setup_context)


def scan(delta, u, bmat, cmat, a, h0, chunk: int) -> tuple[Tensor, Tensor]:
    """``ssm_scan``'s y and h_last, keeping the carries only where a
    backward can follow (grad mode on and an input that requires grad)."""
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (delta, u, bmat, cmat, a, h0))
    y, h, _ = torch.ops.repro_torch.ssm_scan(delta, u, bmat, cmat, a, h0,
                                             chunk, save)
    return y, h
