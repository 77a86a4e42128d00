"""The flash Function's plain backward's share of the training step's card
time (%): the card time of the program's ``flash.backward`` device spans
over that of its ``train.step`` device spans, over the window's steps (CUDA
events; 0 where no flash backward ran in them)."""
from perfbench.spans import device_share_pct


def read(run):
    return device_share_pct(run, "flash.backward")
