# The decoder-only LM (models/transformer.py) and the encoder-decoder LM
# (models/encdec.py) on the hand-written rmsnorm, flash_attention and
# decode_attention kernels; import by module path.
