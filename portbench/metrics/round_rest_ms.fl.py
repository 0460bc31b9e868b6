"""``round_rest_ms.fl``: the FL round loop's own work (``core/server.py``
``Federation.run``: the shuffles, the evaluation, the metrics and the
read-backs between rounds), ms a round: the window's seconds less its
local phases and server steps, over its rounds."""


def read(ctx):
    if not ctx.get("local_s"):
        return None
    rest = ctx["window_s"] - sum(ctx["local_s"]) - sum(ctx["server_s"])
    return 1e3 * rest / ctx["rounds"]
