# Hand-written CUDA kernels for Hopper (csrc/), their wrappers (lstm_seq.py,
# attn_lstm_seq.py) and their plain PyTorch versions (ref.py).  Kernels build on first use,
# never at import.  Import the wrappers by module path
# (``from repro_torch.kernels import lstm_seq``): the package re-exports no
# function under a module's name.
