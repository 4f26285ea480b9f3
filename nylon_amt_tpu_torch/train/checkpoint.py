"""Checkpoints with the reference's (epoch, div) cadence (PyTorch).

Port of :mod:`nylon_amt_tpu.train.checkpoint` without orbax. One directory
per (epoch, div), ``model_{epoch:03d}_{div:03d}/``, holding:

* ``model.dat``: the model in the reference's format, ``{"model_dict":
  state_dict}`` (``m_training.py:374-392``), which ``cli transcribe
  --checkpoint`` loads unchanged;
* ``optimizer.pt``: the Adam state and the step count;
* ``host.json``: host state (scheduler, best tracking, performance, the
  numpy shuffle RNG and the dropout-seed generator), written last, so that
  its presence marks a complete checkpoint.

``best.json`` / ``best_epoch.txt`` beside the directories point at the
best (epoch, div). :func:`load_params` reads a model's ``state_dict`` back
for inference or a warm start, :func:`merge_params` overlays it on a fresh
one.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

# Format version of the port's checkpoints, stored in host.json.
CKPT_FORMAT_VERSION = 1

MODEL_FILE = "model.dat"
OPTIMIZER_FILE = "optimizer.pt"
HOST_FILE = "host.json"


def _tag(epoch: int, div: int) -> str:
    return f"model_{epoch:03d}_{div:03d}"


def _save_atomic(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int, div: int) -> str:
        return os.path.join(self.directory, _tag(epoch, div))

    # -- save ---------------------------------------------------------------

    def save(self, epoch: int, div: int, state, host_state: dict,
             is_best: bool = False) -> str:
        """Persist the model (``.dat``), the optimizer and the host JSON."""
        path = self.path(epoch, div)
        os.makedirs(path, exist_ok=True)
        _save_atomic({"model_dict": {k: v.detach().cpu() for k, v in
                                     state.model.state_dict().items()}},
                     os.path.join(path, MODEL_FILE))
        _save_atomic({"optimizer": state.optimizer.state_dict(),
                      "step": state.step}, os.path.join(path, OPTIMIZER_FILE))
        host_state = {**host_state, "format_version": CKPT_FORMAT_VERSION}
        with open(os.path.join(path, HOST_FILE), "w", encoding="utf-8") as f:
            json.dump(host_state, f, indent=2)
        if is_best:
            with open(os.path.join(self.directory, "best_epoch.txt"),
                      "w") as f:
                f.write(f"epoch: {epoch}, div: {div}\n")
            with open(os.path.join(self.directory, "best.json"), "w") as f:
                json.dump({"epoch": epoch, "div": div}, f)
        return path

    # -- restore --------------------------------------------------------------

    def restore(self, epoch: int, div: int, state) -> tuple[Any, dict]:
        """Load a checkpoint into ``state`` (model, optimizer, step);
        returns ``(state, host)``."""
        path = self.path(epoch, div)
        with open(os.path.join(path, HOST_FILE), "r", encoding="utf-8") as f:
            host = json.load(f)
        found = host.get("format_version")
        if found != CKPT_FORMAT_VERSION:
            raise RuntimeError(f"checkpoint {path} has format version "
                               f"{found}, this build expects "
                               f"{CKPT_FORMAT_VERSION}")
        model = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu",
                           weights_only=True)
        state.model.load_state_dict(model["model_dict"], strict=True)
        opt = torch.load(os.path.join(path, OPTIMIZER_FILE),
                         map_location="cpu", weights_only=True)
        state.optimizer.load_state_dict(opt["optimizer"])
        state.step = int(opt["step"])
        return state, host

    def best_tag(self) -> tuple[int, int] | None:
        p = os.path.join(self.directory, "best.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            d = json.load(f)
        return d["epoch"], d["div"]

    def is_valid(self, epoch: int, div: int) -> bool:
        """True only for a complete checkpoint: ``save()`` writes the model
        and optimizer first and ``host.json`` last."""
        path = self.path(epoch, div)
        return all(os.path.isfile(os.path.join(path, f))
                   for f in (MODEL_FILE, OPTIMIZER_FILE, HOST_FILE))

    def valid_tags(self) -> list[tuple[int, int]]:
        """All complete (epoch, div) checkpoints, sorted ascending."""
        tags = []
        for name in os.listdir(self.directory):
            parts = name.split("_")
            if name.startswith("model_") and len(parts) == 3:
                try:
                    e, d = int(parts[1]), int(parts[2])
                except ValueError:
                    continue
                if self.is_valid(e, d):
                    tags.append((e, d))
        return sorted(tags)

    def prune(self, keep: list[tuple[int, int]]) -> None:
        """Delete checkpoints not in ``keep``."""
        tags = {_tag(e, d) for e, d in keep}
        for name in os.listdir(self.directory):
            if name.startswith("model_") and name not in tags:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)


def merge_params(fresh: dict[str, torch.Tensor],
                 loaded: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Overlay ``loaded`` onto ``fresh`` (two ``state_dict``s), keeping the
    fresh tensors that ``loaded`` lacks.

    The warm-start merge for architectures that EXTEND a pretrained one
    (``nylon_amt_tpu.train.checkpoint.merge_params``): every shared tensor
    comes from the checkpoint, the rest keep their fresh initialisation.
    Raises ``KeyError`` on loaded keys absent from ``fresh`` and
    ``ValueError`` on shape mismatches (a different architecture fails
    loudly).
    """
    extra = set(loaded) - set(fresh)
    if extra:
        raise KeyError(f"checkpoint has parameters the model lacks: "
                       f"{sorted(extra)[:5]}")
    for k, v in loaded.items():
        if tuple(v.shape) != tuple(fresh[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint "
                             f"{tuple(v.shape)} vs model "
                             f"{tuple(fresh[k].shape)}")
    return {k: loaded.get(k, v) for k, v in fresh.items()}


def load_params(path: str, epoch: int | None = None,
                div: int | None = None) -> dict[str, torch.Tensor]:
    """A model's ``state_dict`` (CPU tensors) from ``path``: a run's
    ``checkpoints/`` directory (the ``(epoch, div)`` checkpoint, or without
    both the best one that ``best.json`` names), one ``model_EEE_DDD/``
    directory, or a file: a reference-format ``.dat`` (``{"model_dict":
    state_dict}``) or a bare ``state_dict``."""
    if os.path.isdir(path):
        if not os.path.isfile(os.path.join(path, MODEL_FILE)):
            if epoch is None or div is None:
                mgr = CheckpointManager(path)
                tag = mgr.best_tag()
                if tag is None:
                    raise FileNotFoundError(f"no best checkpoint recorded in "
                                            f"{path}")
                epoch, div = tag
            path = os.path.join(path, _tag(epoch, div))
        path = os.path.join(path, MODEL_FILE)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["model_dict"] if isinstance(obj, dict) and "model_dict" in obj \
        else obj


def rng_state_to_json(rng: np.random.Generator) -> dict:
    return rng.bit_generator.state


def rng_state_from_json(state: dict) -> np.random.Generator:
    gen = np.random.default_rng()
    gen.bit_generator.state = state
    return gen
