"""``server_step_ms.fl``: the FL server step (``core/strategies.py`` →
``coalitions.py`` → ``fused.py``), ms a round: the mean of the window's
``Trace.server_s`` (host clock ended by a synchronise)."""


def read(ctx):
    s = ctx.get("server_s")
    return 1e3 * sum(s) / len(s) if s else None
