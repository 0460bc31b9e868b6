"""``kernel_roofline.pretrain``: the flash-attention kernel
(``kernels/flash_attention.py`` → ``csrc/flash_attention.cu``) in the
traced steps, as a share of its roofline: each call's least time,
max(bytes / 3.35 TB/s, operations / 989 TFLOP/s) with the bytes and
operations of :func:`yardstick.flash_bytes_ops` at the step's shapes,
over the kernel's device time.  Nothing to read where no such kernel ran."""
from portbench.harness import yardstick

KERNELS = r"flash_fwd"


def read(ctx):
    tr, t, cfg = ctx.get("trace"), ctx["traffic"], ctx["cell"].config
    if tr is None:
        return None
    secs, calls = tr.device_total(KERNELS)
    if calls == 0 or secs <= 0:
        return None
    nbytes, ops = yardstick.flash_bytes_ops(
        t["batch"], cfg["n_heads"], cfg["n_kv_heads"], t["seq"] + 1,
        cfg["d_head"], cfg.get("window"))
    least = yardstick.roofline_s(nbytes, ops, yardstick.PEAK_FLOPS["bf16"])
    return 100.0 * calls * least / secs
