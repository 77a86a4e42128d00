"""PyTorch / CUDA port of the JAX package ``repro``, slice by slice.

This slice runs the paper's per-target LSTM closed loop: the cluster
simulator and workloads (numpy), the PPA decision layer, ``FleetController``
with its staged tick, and the LSTM forecaster, whose every forward goes
through a hand-written CUDA kernel on the card (``kernels/csrc/``).  The
package imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
