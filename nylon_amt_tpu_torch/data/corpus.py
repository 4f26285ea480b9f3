"""Corpus assembly: per-piece features/labels -> one windowable split array.

A copy of ``nylon_amt_tpu/data/corpus.py`` (numpy only) for the port.

Rebuild of the reference's ``corpus/make_dataset.py`` with the same geometry
(margins, inter-piece gaps, window-start index array) but TPU-friendly
storage: ``.npy`` files that memory-map straight into the input pipeline
instead of monolithic pickles loaded fully into RAM
(``training/dataset.py:10-39``).

Geometry (reference ``make_dataset.py:25,55,79-81,105-119``):

* the split array starts with ``margin_b`` pad frames;
* each piece occupies ``num_frame_piece`` frames, followed by a gap of
  ``margin_f + num_frame - 1`` frames, so every 192-frame model window whose
  128-frame label region starts inside a piece stays clear of the next piece;
* ``idx`` lists the absolute array offset of every valid window start (one
  per piece frame);
* features are padded with ``log(log_offset)`` (or min-max normalized when
  ``max_value > 0``), labels with zeros.

Sharding: ``n_div > 1`` assigns pieces round-robin to shards
(``make_dataset.py:36-38``), letting hosts stream disjoint shards.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from nylon_amt_tpu_torch.config import Config

LABEL_KEYS = ("onset", "offset", "mpe", "velocity")
_DTYPES = {"feature": np.float32, "onset": np.float32, "offset": np.float32,
           "mpe": bool, "velocity": np.int8, "string": np.int8}


@dataclass
class SplitArrays:
    feature: np.ndarray         # [total, mel_bins] f32
    onset: np.ndarray           # [total, num_note] f32
    offset: np.ndarray          # [total, num_note] f32
    mpe: np.ndarray             # [total, num_note] bool
    velocity: np.ndarray        # [total, num_note] int8
    idx: np.ndarray             # [n_windows] int64 window-start offsets
    # Optional tablature-head targets (ModelConfig.tab_head): 1-based string
    # index at onset cells, 0 elsewhere. None for corpora without string
    # annotations (piano).
    string: np.ndarray | None = None

    def save(self, directory: str, split: str, shard: int | None = None) -> None:
        os.makedirs(directory, exist_ok=True)
        suffix = f"_{shard:03d}" if shard is not None else ""
        for name in ("feature", *LABEL_KEYS, "idx"):
            np.save(os.path.join(directory, f"{split}_{name}{suffix}.npy"),
                    getattr(self, name))
        if self.string is not None:
            np.save(os.path.join(directory, f"{split}_string{suffix}.npy"),
                    self.string)

    @classmethod
    def load(cls, directory: str, split: str, shard: int | None = None,
             mmap: bool = True) -> "SplitArrays":
        suffix = f"_{shard:03d}" if shard is not None else ""
        mode = "r" if mmap else None
        arrays = {
            name: np.load(os.path.join(directory, f"{split}_{name}{suffix}.npy"),
                          mmap_mode=mode)
            for name in ("feature", *LABEL_KEYS, "idx")
        }
        str_path = os.path.join(directory, f"{split}_string{suffix}.npy")
        if os.path.exists(str_path):
            arrays["string"] = np.load(str_path, mmap_mode=mode)
        return cls(**arrays)


def assemble_split(
    config: Config,
    features: list[np.ndarray],
    labels: list[dict[str, np.ndarray]],
) -> SplitArrays:
    """Concatenate per-piece arrays with margins/gaps and build the idx table."""
    inp = config.input
    gap = inp.margin_f + inp.num_frame - 1
    normalize = inp.max_value > 0.0
    pad = 0.0 if normalize else config.pad_value

    num_frames = [max(f.shape[0], l["mpe"].shape[0])
                  for f, l in zip(features, labels)]
    total = inp.margin_b + sum(n + gap for n in num_frames)

    keys = LABEL_KEYS + (("string",) if labels
                         and all("string" in l for l in labels) else ())
    feat = np.full((total, config.feature.mel_bins), pad, dtype=np.float32)
    lab = {k: np.zeros((total, config.midi.num_note), dtype=_DTYPES[k])
           for k in keys}
    idx = np.zeros(sum(num_frames), dtype=np.int64)

    loc_d = inp.margin_b
    loc_i = 0
    for f, l, n in zip(features, labels, num_frames):
        x = np.asarray(f, dtype=np.float32)
        if normalize:
            x = (x - inp.min_value) / (inp.max_value - inp.min_value)
        feat[loc_d : loc_d + x.shape[0]] = x
        for k in keys:
            arr = np.asarray(l[k])
            lab[k][loc_d : loc_d + arr.shape[0]] = arr
        idx[loc_i : loc_i + n] = np.arange(loc_d, loc_d + n)
        loc_i += n
        loc_d += n + gap

    return SplitArrays(feature=feat, idx=idx, **lab)


def build_corpus_split(
    config: Config,
    pieces: list[tuple[np.ndarray, dict[str, np.ndarray]]],
    out_dir: str,
    split: str,
    n_div: int = 1,
) -> None:
    """Assemble + save a split, optionally sharded round-robin over pieces."""
    if n_div <= 1:
        assemble_split(config, [p[0] for p in pieces],
                       [p[1] for p in pieces]).save(out_dir, split)
        return
    for div in range(n_div):
        shard = pieces[div::n_div]
        assemble_split(config, [p[0] for p in shard],
                       [p[1] for p in shard]).save(out_dir, split, shard=div)


def write_manifest(config: Config, out_dir: str, extra: dict | None = None) -> None:
    """Persist the (possibly augmented) config next to the arrays
    (reference ``make_dataset.py:304-308``)."""
    os.makedirs(out_dir, exist_ok=True)
    d = config.to_dict()
    if extra:
        d.update(extra)
    with open(os.path.join(out_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(d, f, ensure_ascii=False, indent=4)
