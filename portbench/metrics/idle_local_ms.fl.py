"""``idle_local_ms.fl``: device idle time inside the FL local phase, ms a
round: each traced round's gap from its ``fl.shuffle`` span's end to its
``fl.server`` span's start (``Federation._local_phase``, the substrate
step and the synchronise that ends ``local_s``) less the device's busy
time inside it.  With ``idle_server_ms.fl`` and ``idle_loop_ms.fl`` it
splits the window's idle time.  Nothing to read where the program marks
no such spans."""
from portbench.harness import phases


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else phases.per_round_ms(
        tr, phases.idle_in(tr, phases.local_phase(tr)))
