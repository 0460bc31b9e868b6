"""``idle_loop_ms.fl``: device idle time in the FL round loop, ms a round:
the traced window's idle time (as ``device_idle.fl`` reads it) outside the
local phases (``fl.shuffle``'s end to ``fl.server``'s start) and the
``fl.server`` spans, so the three idle metrics sum to the window's idle
time over its rounds.  Nothing to read where the program marks no such
spans."""
from portbench.harness import phases


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    local = phases.idle_in(tr, phases.local_phase(tr))
    server = phases.idle_in(tr, phases.spans(tr, "fl.server"))
    if local is None or server is None:
        return None
    idle = tr.window_s - tr.busy_s()
    return phases.per_round_ms(tr, idle - local - server)
