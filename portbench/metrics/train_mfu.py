"""Model FLOPs utilization of training: the forward and backward FLOPs
of the MLM steps completed in the window, over its seconds and the card's
bf16 peak."""

from portbench import arith

UNIT = "%"


def read(run):
    if run.peak is None or not run.steps:
        return None
    flops = run.steps * arith.bert_train_flops(run.model, run.batch, run.seq_len,
                                               run.predictions)
    return 100.0 * flops / run.window_s / run.peak["bf16_flops"]
