"""``local_phase_ms.fl``: the FL local phase (``core/client.py`` through
``Federation._local_phase``), ms a round: the mean of the window's
``Trace.local_s`` (host clock ended by a synchronise)."""


def read(ctx):
    s = ctx.get("local_s")
    return 1e3 * sum(s) / len(s) if s else None
