"""``readback_ms.fl``: the FL round loop's read-back of each round's values
to the host, ms a round: the host duration of the traced rounds'
``fl.readback`` spans (the host waiting on the evaluation and the round's
metric kernels, then the copies).  Nothing to read where the program
marks no such span."""
from portbench.harness import phases


def read(ctx):
    tr = ctx.get("trace")
    sp = [] if tr is None else phases.spans(tr, "fl.readback")
    if not sp:
        return None
    return phases.per_round_ms(tr, sum(e - s for s, e in sp))
