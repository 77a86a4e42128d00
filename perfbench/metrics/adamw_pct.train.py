"""AdamW's share of the training step's card time (%): the card time of the
program's ``train.adamw`` device spans over that of its ``train.step``
device spans, over the window's steps (CUDA events)."""
from perfbench.spans import device_share_pct


def read(run):
    return device_share_pct(run, "train.adamw")
