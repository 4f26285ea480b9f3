"""Float32 precision guard for the plain f32 paths on the card."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and convolutions in IEEE float32, not TF32.

    On CUDA, PyTorch runs float32 convolutions through cuDNN in TF32 by
    default (``torch.backends.cudnn.allow_tf32`` is True), and TF32 keeps
    about three decimal digits. The reference computes the log-mel DFT, the
    encoder stem and the float32 output heads in full float32, so those
    paths run under this guard: it sets ``torch.backends.cuda.matmul.
    allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` to False and
    restores both on exit. On the CPU the flags have no effect.
    """
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
