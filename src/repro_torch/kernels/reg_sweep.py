"""Host side of the register sweep (``csrc/reg_sweep.cuh``).

The fused-round, distance and segment-sum wrappers share it: the vector
width a register kernel loads by (the columns of a row it takes at a time,
as the rows' alignment allows) and the zeroed ticket by which the last CTA
of a sweep finds itself.  The ticket is a 32-bit counter kept here for each
device and stream, so that launches on one stream, which run one after the
other, share it; the last CTA of each launch sets it back to 0.
"""
from __future__ import annotations

import torch

#: the sweep's zeroed ticket, by (device index, stream)
TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def vector_width(d: int, widths: tuple[int, ...],
                 *bases: tuple[torch.dtype, int]) -> int:
    """The widest v of ``widths`` (in order, widest first) such that D is a
    multiple of v and every base, a (dtype, address) pair, is v-element
    aligned: then every row of each (rows, D) matrix is too."""
    for v in widths:
        if d % v == 0 and all(ptr % (v * dtype.itemsize) == 0
                              for dtype, ptr in bases):
            return v
    return 1


def ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The zeroed ticket of ``device``'s ``stream``, made at first use."""
    key = (device.index, stream)
    t = TICKETS.get(key)
    if t is None:
        t = TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t
