"""Test-pass note-level metrics (reference ``train.py:168-254``), PyTorch.

Port of :mod:`nylon_amt_tpu.train.metrics`: ``intervals_from_rolls`` is
its numpy code unchanged; the test pass runs the port's eval forward (the
inference engine where ``engine.supports(config)``, else the deterministic
per-site forward), on the card through the kernels.

After training, the reference runs the test split with ``metrics=True``:
thresholded B-head onset/offset matrices are paired into note intervals
(each onset matched to the next offset frame, 32 ms minimum duration) and
scored with mir_eval against intervals built from the labels
(``reshape_for_mir_eval`` — ``train.py:9-57``).

The reference implementation has documented quirks (SURVEY.md §7.4):

* ``np.where(matrix)`` treats ANY nonzero value as an onset — sigmoid
  posteriors are always positive, so every frame fires (the published
  P=0.01 / R=0.95 follows from this);
* frame times use ``hop_length=512, sample_rate=44100`` defaults instead of
  the actual 256/16000;
* pitch indices 0-87 feed the MIDI-to-Hz formula without ``+ note_min``;
* reference intervals use ``label_onset`` for both onsets and offsets.

The default here fixes all four (0.5 posterior threshold, config hop/sr,
``+ note_min``, offset labels for offsets). ``legacy_quirks=True`` reproduces
the reference behavior bit-for-bit for comparisons against its published
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.metrics.transcription import evaluate_notes, note_to_hz
from nylon_amt_tpu_torch.models.hft import DTYPES, Model


def intervals_from_rolls(
    onset: np.ndarray,
    offset: np.ndarray,
    hop_sec: float,
    note_min: int = 21,
    threshold: float = 0.5,
    min_duration: float = 0.032,
) -> tuple[np.ndarray, np.ndarray]:
    """Frame matrices ``[B, T, n_note]`` -> (intervals [N, 2], pitches_hz).

    Pairing rule per the reference: each onset frame pairs with the first
    offset frame after it, else ``min_duration`` (``train.py:26-45``).
    """
    on = np.asarray(onset) >= threshold if threshold is not None \
        else np.asarray(onset) != 0
    off = np.asarray(offset) >= threshold if threshold is not None \
        else np.asarray(offset) != 0
    min_frames = max(1, int(min_duration / hop_sec))
    T = on.shape[1]

    # Vectorized pairing (the reference's triple Python loop is O(B*T*88)
    # per batch — minutes over a full MAESTRO test split). Encode each
    # (batch, pitch) lane as one integer group; a single searchsorted then
    # finds, for every onset, the first offset strictly after it in the same
    # lane.
    on_b, on_t, on_p = np.nonzero(on)
    if on_b.size == 0:
        return np.array([[0.0, min_duration]]), np.array([440.0])
    off_b, off_t, off_p = np.nonzero(off)

    n_pitch = on.shape[2]
    if off_b.size == 0:
        g = on_t + min_frames
    else:
        on_group = on_b * n_pitch + on_p
        off_group = off_b * n_pitch + off_p
        # Keys sorted by (group, time); np.nonzero emits b-major/t-next
        # order, so re-sort into group-major order.
        off_order = np.lexsort((off_t, off_group))
        off_keys = off_group[off_order] * (T + 1) + off_t[off_order]
        pos = np.searchsorted(off_keys, on_group * (T + 1) + on_t,
                              side="right")
        clamped = off_order[np.minimum(pos, off_keys.size - 1)]
        has_later = (pos < off_keys.size) & (off_group[clamped] == on_group)
        g = np.where(has_later, off_t[clamped], on_t + min_frames)

    t0 = on_t * hop_sec
    t1 = np.maximum(g * hop_sec, t0 + min_duration)
    # Preserve the reference's (batch, pitch, onset-time) emission order.
    emit = np.lexsort((on_t, on_p, on_b))
    intervals = np.stack([t0[emit], t1[emit]], axis=1)
    pitches = note_to_hz(on_p[emit] + note_min)
    return intervals, pitches


def make_note_metrics_fn(config: Config, threshold: float = 0.5,
                         legacy_quirks: bool = False):
    """Build the ``metrics_fn`` consumed by :meth:`Trainer.fit`.

    Returns per-batch-averaged P/R/F1 over the test split, with and without
    the offset condition (``mir_eval.transcription`` semantics), from the
    B heads' posteriors (the A heads' for a stage-1-only decoder).
    """
    if legacy_quirks:
        hop_sec = 512 / 44100
        note_min = 0
        thr = None
    else:
        hop_sec = config.feature.hop_sec
        note_min = config.midi.note_min
        thr = threshold

    @torch.no_grad()
    def metrics_fn(state, test_datasets) -> dict:
        model = state.model
        device = next(model.parameters()).device
        if engine.supports(config):
            packed = engine.pack_params(model,
                                        DTYPES[config.model.compute_dtype])

            def forward(spec):
                return engine.forward(packed, spec, config)
        else:
            def forward(spec):
                return Model.per_site(model, spec)

        totals = {"precision": 0.0, "recall": 0.0, "f1": 0.0,
                  "precision_no_offset": 0.0, "recall_no_offset": 0.0,
                  "f1_no_offset": 0.0}
        n_batches = 0
        bs = config.train.batch_size
        for ds in test_datasets:
            for batch in ds.batches(bs, shuffle=False, pad_to_batch=True):
                out = forward(torch.as_tensor(batch["spec"]).to(device))
                fam = "B" if "onset_B" in out else "A"
                on_post, off_post = (
                    torch.sigmoid(out[f"{k}_{fam}"].float()).cpu().numpy()
                    for k in ("onset", "offset"))
                # The last batch is padded to a static shape by repeating
                # rows; score only the valid rows (the padded duplicates
                # would otherwise be counted twice).
                nv = int(batch["valid"].sum())
                est = intervals_from_rolls(on_post[:nv], off_post[:nv],
                                           hop_sec, note_min, thr)
                ref_off_src = batch["onset"] if legacy_quirks else batch["offset"]
                ref = intervals_from_rolls(batch["onset"][:nv],
                                           ref_off_src[:nv],
                                           hop_sec, note_min,
                                           0.5 if not legacy_quirks else None)
                scores = evaluate_notes(ref[0], ref[1], est[0], est[1])
                totals["precision"] += scores["Precision"]
                totals["recall"] += scores["Recall"]
                totals["f1"] += scores["F-measure"]
                totals["precision_no_offset"] += scores["Precision_no_offset"]
                totals["recall_no_offset"] += scores["Recall_no_offset"]
                totals["f1_no_offset"] += scores["F-measure_no_offset"]
                n_batches += 1
        return {k: v / max(n_batches, 1) for k, v in totals.items()}

    return metrics_fn
