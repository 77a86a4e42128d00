"""Decode steps' model FLOPs over (window time x 989e12), in percent: per
active slot 2 x the parameters its token multiplies plus 4 Hq D times its
visible rows in each layer, windowed (``counts.decode_model_flops``)."""
from perfbench import counts


def read(run):
    steps = run.record.get("steps")
    if not steps:
        return None
    w0, w1 = run.record["window"]
    flops = sum(f for _, _, f in steps)
    return 100.0 * flops / ((w1 - w0) * counts.BF16_FLOP_PER_S)
