"""``idle_server_ms.fl``: device idle time inside the FL server step, ms a
round: the traced rounds' ``fl.server`` spans (round 0's Step I, the
strategy's round, θ made whole, the synchronise that ends ``server_s``)
less the device's busy time inside them.  Nothing to read where the
program marks no such span."""
from portbench.harness import phases


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else phases.per_round_ms(
        tr, phases.idle_in(tr, phases.spans(tr, "fl.server")))
