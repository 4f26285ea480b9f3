"""Device-resident window sampler: the split arrays live on the card, the
window gathers run there.

Port of :mod:`nylon_amt_tpu.data.device_windows`. The host input path
(:meth:`WindowDataset.gather`, then a copy) moves ~3 MB of spectrogram and
labels a batch-8 step. Here each split is uploaded once, and a step sends
only its ``int32[B]`` window starts: :meth:`DeviceWindowDataset.gather`
indexes the resident arrays with torch on the card.

The batches are exactly the host path's (the same index table, margins,
transpose and dtypes; ``spec`` contiguous, as the layer kernels read whole
rows; ``mpe`` float32, ``velocity`` and ``string`` int32), held by
``tests/test_torch_device_windows.py``. The trainer
(:class:`~nylon_amt_tpu_torch.train.loop.Trainer`) wraps a host split
with :func:`as_device_dataset`, keeps it resident under its budget, and
runs its epochs on the card (``Trainer._device_batches``).

When a split is promoted (:func:`as_device_dataset`):

* never on the CPU (the batches are already where the step runs), nor
  under a multi-process ``torch.distributed`` group;
* ``NYLON_DEVICE_DATASET`` ``"1"`` promotes every split that fits, ``"0"``
  none; unset, the JAX package's gate decides (:func:`host_input_is_hidden`:
  hid >= 192 keeps the host path). The variable is read at every call, and
  any other value raises;
* a split larger than ``NYLON_DEVICE_DATASET_MAX_BYTES`` (default 4e9
  bytes) stays on the host; the trainer keeps the resident splits under
  ``NYLON_DEVICE_DATASET_TOTAL_BYTES`` (default 8e9) in all, evicting the
  least recently used.

The gate and both budgets are the JAX package's values, kept so that the
port routes as JAX does; the H100's own numbers for them are in
``PERF.md``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.data.corpus import SplitArrays
from nylon_amt_tpu_torch.data.windows import WindowDataset

ENV_FORCE = "NYLON_DEVICE_DATASET"
ENV_MAX_BYTES = "NYLON_DEVICE_DATASET_MAX_BYTES"
ENV_TOTAL_BYTES = "NYLON_DEVICE_DATASET_TOTAL_BYTES"
_ARRAYS = ("feature", "onset", "offset", "mpe", "velocity", "string")


def host_input_is_hidden(config: Config) -> bool:
    """The JAX package's gate (``data/device_windows.py:47``): models of
    the paper's class (hid >= 192) keep the host input path, smaller ones
    are promoted to the device-resident one."""
    return config.model.hid_dim >= 192


def split_max_bytes() -> float:
    """The largest split that is promoted (``NYLON_DEVICE_DATASET_MAX_BYTES``,
    default 4e9)."""
    return float(os.environ.get(ENV_MAX_BYTES, 4e9))


def device_dataset_budget() -> float:
    """Bytes of all resident splits together
    (``NYLON_DEVICE_DATASET_TOTAL_BYTES``, default 8e9)."""
    return float(os.environ.get(ENV_TOTAL_BYTES, 8e9))


def forced() -> bool | None:
    """``NYLON_DEVICE_DATASET`` as read now: True ("1"), False ("0") or
    None (unset or empty: the gate decides). Raises on any other value."""
    value = os.environ.get(ENV_FORCE, "")
    if value not in ("", "0", "1"):
        raise ValueError(f"{ENV_FORCE}={value!r}: expected '0', '1' or "
                         f"unset")
    return None if value == "" else value == "1"


def promotion_wanted(config: Config) -> bool:
    """Whether a split that fits should be promoted for ``config`` (the
    override, else the gate); the device and the size are not asked."""
    force = forced()
    return (not host_input_is_hidden(config)) if force is None else force


def split_nbytes(arrays: SplitArrays) -> int:
    return sum(getattr(arrays, k).nbytes for k in _ARRAYS
               if getattr(arrays, k) is not None)


class DeviceWindowDataset(WindowDataset):
    """A :class:`WindowDataset` whose arrays are on ``device`` and whose
    ``gather`` runs there; ``batches`` (inherited) yields its batches as
    tensors on ``device``, the ``valid`` mask as a numpy array."""

    def __init__(self, arrays: SplitArrays, config: Config, n_slice: int = 1,
                 device: torch.device | str = "cuda"):
        super().__init__(arrays, config, n_slice)
        self.device = torch.device(device)
        self.cached_nbytes = split_nbytes(arrays)
        inp = config.input
        self._f_off = torch.arange(-inp.margin_b,
                                   inp.num_frame + inp.margin_f,
                                   device=self.device)
        self._l_off = torch.arange(inp.num_frame, device=self.device)
        self._dev: dict[str, torch.Tensor] = {}
        self.refresh()        # one upload a split (memmaps are read here)

    def gather(self, positions: np.ndarray) -> dict[str, torch.Tensor]:
        """Positions (indices into ``self.idx``) -> the host gather's batch,
        on the card."""
        starts = self.idx[np.asarray(positions)].astype(np.int32)
        return self.gather_starts(torch.from_numpy(starts).to(self.device))

    def gather_starts(self, starts: torch.Tensor) -> dict[str, torch.Tensor]:
        """Window starts (absolute frame offsets, int32 ``[B]`` on the
        device) -> the batch."""
        self.ensure_resident()
        dev = self._dev
        s = starts.long()[:, None]
        f_idx, l_idx = s + self._f_off, s + self._l_off
        batch = {
            "spec": dev["feature"][f_idx].transpose(1, 2).contiguous(),
            "onset": dev["onset"][l_idx],
            "offset": dev["offset"][l_idx],
            "mpe": dev["mpe"][l_idx].float(),
            "velocity": dev["velocity"][l_idx].int(),
        }
        if "string" in dev:               # tablature-head targets
            batch["string"] = dev["string"][l_idx].int()
        return batch

    @property
    def resident(self) -> bool:
        """Whether the split's arrays are on the device now."""
        return bool(self._dev)

    def ensure_resident(self) -> None:
        """Upload again if the arrays were freed (the trainer's LRU can
        evict a split that a caller still holds; the trainer re-admits it
        through its cache before it reads it again)."""
        if not self.resident:
            self.refresh()

    def refresh(self) -> None:
        """(Re-)upload the split's arrays."""
        with warnings.catch_warnings():
            # a memory-mapped split is read-only; nothing writes through
            # the host tensor, which only feeds the copy
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable")
            self._dev = {k: torch.from_numpy(np.ascontiguousarray(v))
                         .to(self.device)
                         for k in _ARRAYS
                         if (v := getattr(self.arrays, k)) is not None}

    def delete(self) -> None:
        """Free the split's device memory (``ensure_resident`` brings it
        back)."""
        self._dev = {}


def _multi_process() -> bool:
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def as_device_dataset(ds, config: Config, device: torch.device | str):
    """``ds`` (a host :class:`WindowDataset`) as a
    :class:`DeviceWindowDataset` on ``device`` where that is wanted and the
    split fits; otherwise ``ds`` unchanged (always on the CPU)."""
    if (not isinstance(ds, WindowDataset)
            or isinstance(ds, DeviceWindowDataset)):
        return ds
    wanted = promotion_wanted(config)     # reads (and checks) the override
    if torch.device(device).type == "cpu" or _multi_process() or not wanted:
        return ds
    if split_nbytes(ds.arrays) > split_max_bytes():
        return ds
    dev = DeviceWindowDataset(ds.arrays, ds.config, n_slice=1, device=device)
    dev.idx = ds.idx             # the caller's table, n_slice applied
    return dev
