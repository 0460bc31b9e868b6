"""Algorithm 1 (paper §III.C), one server round, in plain PyTorch f64.

Step I walks a random permutation of the clients and takes a client as a
centre when its weights differ from every centre taken so far (the first
K of the permutation if fewer than K differ).  Step II puts each client in
the coalition of its nearest centre, each centre in its own.  Step III
takes each coalition's barycenter (the mean of its members; an empty
coalition keeps its centre's weights) and, as the next centre, the member
nearest its barycenter (the nearest client overall where a coalition has
no member).  Step IV: θ is the mean of the barycenters.

Where two choices are equally near (a two-member coalition's members are
equidistant from its barycenter), rounding decides which one an f32
program takes.  :func:`bad_choices` therefore accepts any choice within
:data:`TIE` (relative) of the nearest, and :func:`aggregate` continues
from the choices the program made.
"""
from __future__ import annotations

import torch

#: relative slack of a tie: the f32 rounding of a sum of ~1e6 squares
TIE = 1e-5


def sq_dists(w: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(N, K) squared distances in f64, by differences (no Gram form)."""
    return torch.stack([((w - p[None, :]) ** 2).sum(1) for p in pts], 1)


def first_centers(w: torch.Tensor, perm: list[int], k: int) -> list[int]:
    """Step I on the (N, D) client matrix ``w``."""
    sel: list[int] = []
    for cand in perm:
        if len(sel) == k:
            break
        row = w[cand].double()
        if all(float(((row - w[s].double()) ** 2).sum()) > 0.0 for s in sel):
            sel.append(cand)
    return sel if len(sel) == k else list(perm[:k])


def bad_choices(d2: torch.Tensor, chosen: torch.Tensor,
                allowed: torch.Tensor | None = None) -> int:
    """How many rows of the (M, K) distances ``d2`` chose a column
    (``chosen``, (M,)) that is not within :data:`TIE` of the row's nearest
    allowed column (``allowed``, (M, K) bool, default all)."""
    if allowed is not None:
        d2 = torch.where(allowed, d2, torch.full_like(d2, float("inf")))
    best = d2.min(1).values
    got = d2.gather(1, chosen.long()[:, None])[:, 0]
    return int((~(got <= best * (1 + TIE))).sum())


def assign(w: torch.Tensor, centers: list[int]):
    """Step II: (the (N, K) f64 squared distances to the centres, the
    allowed choices: every coalition, a centre only its own)."""
    wd = w.double()
    d2 = sq_dists(wd, wd[centers])
    allowed = torch.ones_like(d2, dtype=torch.bool)
    for j, c in enumerate(centers):
        allowed[c] = False
        allowed[c, j] = True
    return d2, allowed


def aggregate(w: torch.Tensor, centers: list[int],
              assignment: torch.Tensor) -> dict:
    """Steps III-IV from an assignment: counts, barycenters, the (N, K)
    distances to them, which members may be the next centres, θ."""
    wd = w.double()
    k = len(centers)
    counts = torch.bincount(assignment, minlength=k).double()
    bary = torch.stack([wd[assignment == j].mean(0) if counts[j] > 0
                        else wd[centers[j]] for j in range(k)])
    med = sq_dists(wd, bary)
    member = assignment[:, None] == torch.arange(k, device=w.device)[None]
    # a coalition without members elects over every client
    member = member | ~member.any(0, keepdim=True)
    return {"counts": counts, "barycenters": bary, "med": med,
            "member": member, "theta": bary.mean(0)}
