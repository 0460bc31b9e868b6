"""``kernel_roofline.fl``: the fused coalition round's two kernels
(``kernels/ops.py`` → ``csrc/fused_round.cu``) in the traced rounds, as a
share of their byte bound: each round's two passes read W once each
(:func:`yardstick.fused_round_bytes`) at 3.35 TB/s, over the device time
of the kernels of ``fused_round.cu`` by name.  Nothing to read where the
round ran no such kernel."""
from portbench.harness import yardstick

KERNELS = r"reg_sq_dists|tile_sq_dists|reduce_partials"


def read(ctx):
    tr, t = ctx.get("trace"), ctx["traffic"]
    if tr is None:
        return None
    secs, n = tr.device_total(KERNELS)
    if n == 0 or secs <= 0:
        return None
    d = ctx["cell"].config["n_params"]
    nbytes = tr.steps * yardstick.fused_round_bytes(
        t["n_clients"], t["n_coalitions"], d)
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / secs
