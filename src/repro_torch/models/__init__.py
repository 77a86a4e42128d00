# The dense decoder LM (models/transformer.py) on the hand-written rmsnorm,
# flash_attention and decode_attention kernels; import by module path.
