"""Carry weights from the JAX package's flax parameters to the port.

``params_from_jax`` walks :func:`nylon_amt_tpu_torch.train.importer.build_rules`
(the reference ``state_dict`` key table) with the importer's transforms
(``nylon_amt_tpu/train/importer.py:162-176``): Linear kernels are
transposed to torch's ``[out, in]``, the stem conv ``[C, k]`` becomes ``[C,
1, 1, k]``, a conv block's HWIO kernel becomes OIHW, the BatchNorm running
statistics come from the ``batch_stats`` collection, and
``num_batches_tracked`` (which flax does not keep) starts at 0. With it,
the tests run the JAX package and the port on identical weights.
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


def params_from_jax(params: Mapping[str, Any], config: Config,
                    batch_stats: Mapping[str, Any] | None = None
                    ) -> dict[str, torch.Tensor]:
    """Nested flax params (numpy or array-likes), and the ``batch_stats``
    of a BatchNorm model, -> reference-named float32 ``state_dict``. Raises
    ``KeyError`` for a leaf the rules do not cover (a tree of another
    architecture than ``config``'s)."""
    m = config.model
    rules = build_rules(m.enc_layer, m.dec_layer, m.enc_alg, m.dec_alg,
                        tab_head=m.tab_head)
    trees = {"params": params, "batch_stats": batch_stats or {}}
    sd: dict[str, torch.Tensor] = {}
    used = {name: set() for name in trees}
    for key, (path, tf) in rules.items():
        if tf == "skip":
            sd[key] = torch.tensor(0, dtype=torch.int64)
            continue
        tree = "batch_stats" if tf == "batch_stat" else "params"
        node = trees[tree]
        for p in path:
            node = node[p]
        used[tree].add(path)
        arr = np.asarray(node, dtype=np.float32)
        if tf == "T":
            arr = arr.T
        elif tf == "conv":
            arr = arr.reshape(arr.shape[0], 1, 1, arr.shape[1])
        elif tf == "conv2d":
            arr = arr.transpose(3, 2, 0, 1)       # flax HWIO -> torch OIHW
        elif tf not in ("=", "batch_stat"):
            raise KeyError(f"{key}: transform {tf!r} is not ported")
        sd[key] = torch.from_numpy(np.array(arr, order="C", copy=True))
    for name, tree in trees.items():
        uncovered = set(_leaves(tree)) - used[name]
        if uncovered:
            raise KeyError(f"{name} leaves the reference rules do not cover: "
                           f"{sorted('/'.join(p) for p in uncovered)[:5]}")
    return sd
