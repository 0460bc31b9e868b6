"""``local_launches.fl``: kernel launches in the FL local phase a round:
the host's launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``) that
start inside the traced rounds' local phases (``fl.shuffle``'s end to
``fl.server``'s start).  Nothing to read where the program marks no such
spans."""
import bisect

from portbench.harness import phases


def read(ctx):
    tr = ctx.get("trace")
    sp = [] if tr is None else phases.local_phase(tr)
    if not sp or tr.steps <= 0:
        return None
    starts = [s for s, _ in sp]
    n = 0
    for name, s, _ in tr.host:
        if name.startswith(phases.LAUNCHES):
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s <= sp[i][1]
    return n / tr.steps
