# Hand-written CUDA kernels for Hopper (csrc/), their wrappers and their
# plain PyTorch versions (ref.py): lstm_seq.py and attn_lstm_seq.py (the
# forecasters), rmsnorm.py, flash_attention.py and decode_attention.py (the
# decode engine's decoder).  Kernels build on first use, never at import.
# Import the wrappers by module path (``from repro_torch.kernels import
# lstm_seq``): the package re-exports no function under a module's name.
