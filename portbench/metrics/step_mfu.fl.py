"""``step_mfu.fl``: the whole FL round as a share of the card's f32 peak
(67 TFLOP/s: the configuration runs with TF32 off): the model FLOPs of
every client sample the window trained (:func:`yardstick.cnn_sample_flops`
each) over the window's seconds."""
from portbench.harness import yardstick


def read(ctx):
    return 100.0 * ctx["flops"] / ctx["window_s"] / yardstick.PEAK_FLOPS["f32"]
