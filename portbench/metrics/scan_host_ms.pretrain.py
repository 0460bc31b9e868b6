"""``scan_host_ms.pretrain``: host time a train step inside the SSM scan
op (``models/ssm_scan.py``: ``repro_torch::ssm_scan`` and
``repro_torch::ssm_scan_backward``), from the profile's op events, nested
calls counted once.  Nothing to read where the step runs no such op."""

OPS = ("repro_torch::ssm_scan", "repro_torch::ssm_scan_backward")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.steps == 0:
        return None
    secs = tr.host_total(OPS)
    return 1e3 * secs / tr.steps if secs > 0 else None
