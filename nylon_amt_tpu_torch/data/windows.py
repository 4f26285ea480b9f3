"""Window sampling over assembled split arrays.

Port of ``nylon_amt_tpu/data/windows.py`` (numpy only), with the epoch's
order and padding in :func:`epoch_plan`, which the trainer's device epoch
shares.

Equivalent of the reference's ``training/dataset.py`` (``MyDataset``), but
batch-vectorized: a batch of window starts gathers ``spec [B, n_bins, 192]``
and the four ``[B, 128, 88]`` label windows in one fancy-index operation,
ready for a single host->device transfer (vs per-item ``__getitem__`` +
collate). ``n_slice`` subsampling matches ``dataset.py:35-38``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.data.corpus import SplitArrays


class WindowDataset:
    """Batched window sampler over a :class:`SplitArrays`."""

    def __init__(self, arrays: SplitArrays, config: Config, n_slice: int = 1):
        self.arrays = arrays
        self.config = config
        idx = np.asarray(arrays.idx)
        if n_slice > 1:
            idx = idx[: (len(idx) // n_slice) * n_slice][::n_slice]
        self.idx = idx

    def __len__(self) -> int:
        return len(self.idx)

    def gather(self, positions: np.ndarray) -> dict[str, np.ndarray]:
        """Batch of window starts (indices into ``self.idx``) -> arrays.

        Returns ``spec [B, n_bins, margin+frames+margin]`` (transposed like
        ``dataset.py:56``), float32 labels, int32 velocity classes.
        """
        inp = self.config.input
        starts = self.idx[np.asarray(positions)]
        f_idx = starts[:, None] + np.arange(-inp.margin_b,
                                            inp.num_frame + inp.margin_f)
        l_idx = starts[:, None] + np.arange(inp.num_frame)

        spec = np.asarray(self.arrays.feature)[f_idx]          # [B, 192, bins]
        batch = {
            "spec": np.ascontiguousarray(spec.transpose(0, 2, 1)),
            "onset": np.asarray(self.arrays.onset)[l_idx],
            "offset": np.asarray(self.arrays.offset)[l_idx],
            "mpe": np.asarray(self.arrays.mpe)[l_idx].astype(np.float32),
            "velocity": np.asarray(self.arrays.velocity)[l_idx].astype(np.int32),
        }
        if self.arrays.string is not None:   # tablature-head targets
            batch["string"] = np.asarray(
                self.arrays.string)[l_idx].astype(np.int32)
        return batch

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        rng: np.random.Generator | None = None,
        drop_last: bool = False,
        pad_to_batch: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Iterate batches for one epoch.

        ``pad_to_batch`` repeats trailing windows so every batch has a static
        shape (keeps XLA from recompiling on the last partial batch); a
        ``valid`` mask marks real rows.

        Multi-host: ``batch_size`` is the GLOBAL batch size. Every process
        walks the identical global order (callers seed ``rng`` identically)
        and gathers only its ``batch_size / process_count``-row slice of
        each global batch; ``shard_batch`` then assembles the global device
        array from the per-process rows. With ``process_count=1`` this is
        the plain single-host iterator.
        """
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} must divide across "
                             f"{process_count} processes")
        local = batch_size // process_count
        lo, hi = process_index * local, (process_index + 1) * local
        for pos, mask in epoch_plan(len(self.idx), batch_size, shuffle, rng,
                                    drop_last, pad_to_batch):
            if len(pos) < batch_size and process_count > 1:
                # ragged tail: only meaningful single-process (a global
                # array needs equal per-process rows)
                raise ValueError("multi-host iteration requires "
                                 "pad_to_batch or drop_last")
            batch = self.gather(pos[lo:hi] if process_count > 1 else pos)
            batch["valid"] = mask[lo:hi] if process_count > 1 else mask
            yield batch

    @property
    def steps_per_epoch(self) -> int:
        return -(-len(self.idx) // self.config.train.batch_size)


def epoch_plan(n: int, batch_size: int, shuffle: bool = False,
               rng: np.random.Generator | None = None,
               drop_last: bool = False, pad_to_batch: bool = False
               ) -> list[tuple[np.ndarray, np.ndarray]]:
    """One epoch over ``n`` windows as ``(positions, valid)`` per batch.

    The order is ``arange(n)``, shuffled in place by ``rng`` when
    ``shuffle`` (one ``rng.shuffle`` an epoch: the generator's state after
    it is what the checkpoints save). A short tail batch is dropped
    (``drop_last``), padded to ``batch_size`` by repeating its own
    positions with ``valid`` 0 on the repeats (``pad_to_batch``), or kept
    ragged. :meth:`WindowDataset.batches` gathers these batches on the
    host; the trainer's device epoch uploads them once.
    """
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    plan = []
    for i in range(0, n, batch_size):
        pos = order[i: i + batch_size]
        mask = np.ones(len(pos), np.float32)
        if len(pos) < batch_size:
            if drop_last:
                break
            if pad_to_batch:
                mask = (np.arange(batch_size) < len(pos)).astype(np.float32)
                pos = np.resize(pos, batch_size)
        plan.append((pos, mask))
    return plan
