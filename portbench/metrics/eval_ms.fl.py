"""``eval_ms.fl``: the FL round loop's evaluation on the test set and the
round's metrics, ms a round: the device's busy time from the start of each
traced round's ``fl.eval`` span to the end of its ``fl.readback`` span
(the test-set forward pass, the metric kernels and the read-back copies).
Nothing to read where the program marks no such spans."""
from portbench.harness import phases


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    evals = phases.spans(tr, "fl.eval")
    backs = phases.spans(tr, "fl.readback")
    if not evals or len(evals) != len(backs):
        return None
    rounds = [(ev[0], rb[1]) for ev, rb in zip(evals, backs)]
    return phases.per_round_ms(tr, phases.overlap(rounds, phases.busy(tr)))
