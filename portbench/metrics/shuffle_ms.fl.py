"""``shuffle_ms.fl``: the FL round loop's shuffles (``Federation._shuffles``:
the CPU draws, their argsort and the copy to the device), ms a round: the
host duration of the traced rounds' ``fl.shuffle`` spans.  Nothing to read
where the program marks no such span."""
from portbench.harness import phases


def read(ctx):
    tr = ctx.get("trace")
    sp = [] if tr is None else phases.spans(tr, "fl.shuffle")
    if not sp:
        return None
    return phases.per_round_ms(tr, sum(e - s for s, e in sp))
