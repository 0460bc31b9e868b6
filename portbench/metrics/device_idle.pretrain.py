"""``device_idle.pretrain``: the share of the traced train steps in which
no operation ran on the device (``torch.profiler``)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
