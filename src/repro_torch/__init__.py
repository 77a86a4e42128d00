"""PyTorch / CUDA port of the JAX package ``repro``, slice by slice.

The port runs the paper's per-target LSTM and Attention-Double-LSTM closed
loops and its PPA-vs-HPA harness: the cluster simulator and workloads
(numpy), the PPA decision layer, ``FleetController`` with its staged tick,
and the forecasters, whose every forward goes through a hand-written CUDA
kernel on the card.  It also runs the LLM decode engine the PPA scales:
``serving.DecodeEngine`` + ``ContinuousBatcher`` on the dense decoder
(``models/``), whose norms and attentions go through three more kernels
(``rmsnorm``, ``flash_attention``, ``decode_attention``; all in
``kernels/csrc/``).  The package imports ``torch`` and numpy, never ``jax``
or ``repro``.
"""
