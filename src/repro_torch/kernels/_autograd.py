"""The plain backward of the kernels' ``autograd.Function``s: the kernel
runs the forward, and the gradients come from autograd through the plain
version (``kernels/ref.py``) recomputed on the saved inputs, checkpoint
style.  The norm's, the chunk scan's and the LSTMs' Functions use it for
every call; flash's only where its backward kernels do not take the call
(float32, a head dim above 128)."""
from __future__ import annotations

import torch


def plain_grads(plain, saved, need, grad_outputs):
    """Gradients of ``plain(*saved)`` for the inputs where ``need`` is true
    (None elsewhere), given the outputs' gradients (a tensor, or a tuple
    with None for an output that got none).  ``saved`` may hold None for an
    absent optional input."""
    if isinstance(grad_outputs, torch.Tensor):
        grad_outputs = (grad_outputs,)
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, need)]
        outs = plain(*inputs)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        wanted = [t for t, n in zip(inputs, need) if n]
        if not pairs or not wanted:
            return (None,) * len(need)
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True))
    return tuple(next(grads) if n else None for n in need)
