"""The whole training step's share of the bf16 peak (%): 6 N tokens over
(window time x 989e12), N every parameter the program holds
(``counts.decoder_params``: 1,835,133,440 for h2o-danube-1.8b, the padded
vocabulary tables included); attention-score FLOPs are not counted."""
from perfbench import counts


def read(run):
    r = run.record
    if not r.get("steps") or r["window_s"] <= 0:
        return None
    flops = counts.train_model_flops(run.cell.cfg, r["tokens"])
    return 100.0 * flops / (r["window_s"] * counts.BF16_FLOP_PER_S)
