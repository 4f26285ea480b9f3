"""From-scratch weights by the reference's recipe, from an explicit
generator.

Port of :func:`nylon_amt_tpu.models.init.reference_initialize` semantics:
the reference starts from ``model.apply(initialize_weights)``
(``m_training.py:31-33,141``), i.e. xavier-uniform on every parameter of
dim > 1 (all Linears, Embeddings and the stem Conv2d, with torch's fans),
while Linear/Conv2d biases keep torch's default ``U(+-1/sqrt(fan_in))`` and
LayerNorm keeps ones/zeros.

Every draw comes from the ``torch.Generator`` passed in, on the CPU, and is
copied to the parameter's device: the same seed gives the same weights on
any device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _uniform_(p: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    draw = torch.empty(p.shape, dtype=torch.float32)
    draw.uniform_(-bound, bound, generator=gen)
    p.copy_(draw)


@torch.no_grad()
def reference_initialize(model: nn.Module, generator: torch.Generator
                         ) -> nn.Module:
    """Initialise ``model`` in place (modules in registration order) and
    return it."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.Embedding)):
            w = module.weight
            if isinstance(module, nn.Embedding):   # [num, dim]
                fan_in, fan_out = w.shape[1], w.shape[0]
            else:                                  # [out, in, *kernel]
                fan_in = w[0].numel()
                fan_out = w.shape[0] * w[0][0].numel()
            _uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), generator)
            if getattr(module, "bias", None) is not None:
                _uniform_(module.bias, 1.0 / math.sqrt(fan_in), generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
    return model
