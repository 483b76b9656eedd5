"""The flash forward kernel's share of its roofline in the traced
capture: the least time each of its calls at the step's shapes could take
(q, k, v and the key mask read once, the output and log-sum-exp written
once, at the HBM bandwidth or the bf16 peak, whichever is longer), over
the device time of its records."""

from portbench import arith

UNIT = "%"
MARKER = "flash_fwd"


def read(run):
    tv = run.trace
    if tv is None or run.peak is None:
        return None
    recs = tv.kernels(MARKER)
    if not recs:
        return None
    m = run.model
    nh = m["num_attention_heads"]
    bound = arith.flash_call_bound_s(run.batch, nh, run.seq_len, run.seq_len,
                                     m["hidden_size"] // nh, run.peak)
    return 100.0 * bound * len(recs) / sum(e - s for s, e in recs)
