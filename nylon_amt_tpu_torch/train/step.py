"""Train and eval steps, the loss and the optimizer (PyTorch).

Port of :mod:`nylon_amt_tpu.train.step`. The loss mirrors the reference
(``training/train.py:141-153``): per head family (A = stage 1, B = stage
2), BCE on onset/offset/mpe plus cross-entropy on the 128-class velocity
(and, for a tab-head model on a batch with ``string`` labels, on the string
classes), summed, then ``weight_A * loss_A + weight_B * loss_B``; the heads stay
logits (sigmoid-BCE-with-logits, the JAX package's documented divergence
from the reference's BCELoss on sigmoids). A batch may carry a ``valid``
row mask: masked rows add nothing and the mean divides by the valid count.

The train step runs the model's training forward, chosen as the JAX step
chooses it (:func:`make_apply`): the training layer kernels
(:mod:`nylon_amt_tpu_torch.models.fused_train`) when they cover the
configuration, else the module's per-site forward (:meth:`HFT.per_site`:
K10-K12 attention, K6 dropout, ``remat``, the attention map, the ablation
models and their BatchNorm). Then Adam (torch's, with the optax defaults
the JAX package uses: b1 0.9, b2 0.999, eps 1e-8) with optional
global-norm clipping. The eval step runs the inference engine on freshly
packed weights where it covers the configuration, as the JAX eval step
runs its engine, and the deterministic per-site forward elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.models import fused_train
from nylon_amt_tpu_torch.models.hft import (
    DTYPES, Model, build_model, draw_site_seeds)
from nylon_amt_tpu_torch.models.init import reference_initialize


@dataclasses.dataclass
class TrainState:
    """The model (float32 parameters), its optimizer and the step count."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(config: Config, params) -> torch.optim.Adam:
    """Adam with torch's (= optax's) defaults and eps 1e-8 at
    ``config.train.lr``; the learning rate is the param group's ``lr``."""
    return torch.optim.Adam(params, lr=config.train.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def clip_by_global_norm(params, max_norm: float) -> None:
    """Scale the gradients by ``max_norm / max(norm, max_norm)`` (optax's
    ``clip_by_global_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = max_norm / torch.maximum(norm, torch.tensor(max_norm,
                                                        device=norm.device))
    for g in grads:
        g.mul_(scale.to(g.dtype))


def _sigmoid_bce(logits, labels):
    """optax ``sigmoid_binary_cross_entropy``, in the logits' dtype."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def make_apply(config: Config) -> tuple[Callable, Callable]:
    """``(apply, draw_seeds)`` of the training forward, routed as the JAX
    step routes it (``train/step.py:204-208``): the fused layer kernels
    when ``fused_train.supports(config)``, the per-site forward otherwise.
    ``draw_seeds(config, generator)`` gives one step's dropout seeds."""
    if fused_train.supports(config):
        return fused_train.make_fused_apply(config), fused_train.draw_seeds
    return Model.per_site, draw_site_seeds


def loss_fn(config: Config, apply_fn: Callable, model, batch: dict,
            seeds: Mapping | None = None,
            denom: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """``(loss, metrics)`` of ``apply_fn(model, batch["spec"], seeds)``
    against the batch's targets; ``seeds`` None runs without dropout."""
    out = apply_fn(model, batch["spec"], seeds)
    B = batch["spec"].shape[0]
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones((B,), dtype=torch.float32,
                           device=batch["spec"].device)
    if denom is None:
        denom = torch.clamp(valid.sum(), min=1.0)

    def row_mean(per):
        return per.mean(dim=tuple(range(1, per.dim())))

    def bce(logits, targets):
        return (row_mean(_sigmoid_bce(logits, targets)) * valid).sum() / denom

    def ce(logits, labels):
        # the JAX package's masked-reduce form of the integer-label CE
        lg = logits.float()
        shifted = lg - lg.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(shifted).sum(-1))
        classes = torch.arange(lg.shape[-1], device=lg.device)
        onehot = labels.long()[..., None] == classes
        label_logit = torch.where(onehot, shifted,
                                  torch.zeros_like(shifted)).sum(-1)
        return (row_mean(lse - label_logit) * valid).sum() / denom

    metrics, totals = {}, {}
    fams = ("A", "B") if "onset_B" in out else ("A",)
    for fam in fams:
        l_on = bce(out[f"onset_{fam}"], batch["onset"])
        l_off = bce(out[f"offset_{fam}"], batch["offset"])
        l_mpe = bce(out[f"mpe_{fam}"], batch["mpe"])
        l_vel = ce(out[f"velocity_{fam}"], batch["velocity"])
        totals[fam] = l_on + l_off + l_mpe + l_vel
        metrics.update({f"loss_onset_{fam}": l_on, f"loss_offset_{fam}": l_off,
                        f"loss_mpe_{fam}": l_mpe,
                        f"loss_velocity_{fam}": l_vel})
        # the tab head (ModelConfig.tab_head): string-class CE over the same
        # grid, trained only when the batch carries string labels (a tab
        # model fine-tuning on piano data skips the term)
        if f"string_{fam}" in out and "string" in batch:
            l_str = ce(out[f"string_{fam}"], batch["string"])
            totals[fam] = totals[fam] + l_str
            metrics[f"loss_string_{fam}"] = l_str
    loss = config.train.weight_A * totals["A"]
    if "B" in totals:
        loss = loss + config.train.weight_B * totals["B"]
    metrics["loss"] = loss
    return loss, metrics


def to_device(batch: Mapping[str, np.ndarray], device) -> dict:
    """A host batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def create_train_state(config: Config, seed: int,
                       device: torch.device | str) -> TrainState:
    """A fresh model by the reference's init recipe (from a CPU generator
    seeded with ``seed``) and its optimizer."""
    model = build_model(config, device)
    reference_initialize(model, torch.Generator().manual_seed(seed))
    model.train()
    return TrainState(model, make_optimizer(config, model.parameters()))


def train_step(config: Config, state: TrainState, batch: dict,
               seeds: Mapping | None, apply_fn: Callable | None = None
               ) -> dict:
    """One optimizer step on ``batch`` (tensors on the model's device);
    updates ``state`` in place and returns the metrics (device scalars,
    detached). ``seeds`` (of :func:`make_apply`'s ``draw_seeds``) None
    trains without dropout."""
    apply_fn = apply_fn or make_apply(config)[0]
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(config, apply_fn, state.model, batch, seeds)
    loss.backward()
    if config.train.clip is not None:
        clip_by_global_norm(list(state.model.parameters()), config.train.clip)
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def pack_for_eval(config: Config, state: TrainState) -> engine.PackedHFT:
    """The model's current weights packed for the inference engine."""
    return engine.pack_params(state.model,
                              DTYPES[config.model.compute_dtype])


@torch.no_grad()
def eval_step(config: Config, state: TrainState, batch: dict,
              packed: engine.PackedHFT | None = None) -> dict:
    """Validation losses of ``batch``: through the inference engine (the
    layer kernels on CUDA, their plain versions on the CPU), on ``packed``
    or on freshly packed weights, where ``engine.supports(config)``; else
    through the deterministic per-site forward (BatchNorm on its running
    statistics), as the JAX eval step falls back to ``model.apply``."""
    if not engine.supports(config):
        _, metrics = loss_fn(config, Model.per_site, state.model, batch)
        return metrics
    packed = packed or pack_for_eval(config, state)

    def engine_apply(model, spec, seeds=None):
        return engine.forward(packed, spec, config)

    _, metrics = loss_fn(config, engine_apply, state.model, batch)
    return metrics
