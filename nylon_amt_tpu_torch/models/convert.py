"""Carry weights from the JAX package's flax parameters to the port.

``params_from_jax`` walks :func:`nylon_amt_tpu_torch.train.importer.build_rules`
(the reference ``state_dict`` key table) with the same transforms as the
importer: Linear kernels are transposed to torch's ``[out, in]``, the stem
conv ``[C, k]`` becomes ``[C, 1, 1, k]``. With it, the tests run the JAX
package and the port on identical weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.train.importer import build_rules


def _leaves(tree: Mapping[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def params_from_jax(params: Mapping[str, Any], config: Config
                    ) -> dict[str, torch.Tensor]:
    """Nested flax params (numpy or array-likes) -> reference-named float32
    ``state_dict``. Raises ``KeyError`` for a leaf the rules do not cover
    (an architecture the port does not carry, such as the tab head)."""
    m = config.model
    rules = build_rules(m.enc_layer, m.dec_layer, m.enc_alg, m.dec_alg)
    sd: dict[str, torch.Tensor] = {}
    used = set()
    for key, (path, tf) in rules.items():
        node = params
        for p in path:
            node = node[p]
        used.add(path)
        arr = np.asarray(node, dtype=np.float32)
        if tf == "T":
            arr = arr.T
        elif tf == "conv":
            arr = arr.reshape(arr.shape[0], 1, 1, arr.shape[1])
        elif tf != "=":
            raise KeyError(f"{key}: transform {tf!r} is not ported")
        sd[key] = torch.from_numpy(np.array(arr, order="C", copy=True))
    uncovered = set(_leaves(params)) - used
    if uncovered:
        raise KeyError(f"params leaves the reference rules do not cover: "
                       f"{sorted('/'.join(p) for p in uncovered)[:5]}")
    return sd
