"""``launches_per_step.pretrain``: device kernels a train step
(``launch/steps.py``), counted in the traced steps' profile (copies and
sets left out)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.steps == 0:
        return None
    return tr.kernels() / tr.steps
