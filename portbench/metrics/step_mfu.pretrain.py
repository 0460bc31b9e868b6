"""``step_mfu.pretrain``: the whole train step as a share of the card's
bf16 peak (989 TFLOP/s): the model FLOPs of the window's steps
(:func:`yardstick.lm_step_flops`) over the window's seconds."""
from portbench.harness import yardstick


def read(ctx):
    return 100.0 * ctx["flops"] / ctx["window_s"] / \
        yardstick.PEAK_FLOPS["bf16"]
