"""Corpus-level evaluation functions.

The port's copy of ``nylon_amt_tpu/metrics/harness.py`` (imports aside,
the same code).

Equivalents of the reference's offline scorers: per-file note-level metrics
with corpus averages (``evaluation/m_transcription.py:89-143``) and
frame-level multipitch metrics at a configurable grid
(``evaluation/m_mpe.py:77-180``), operating on note-event lists instead of
txt intermediates.
"""

from __future__ import annotations

import numpy as np

from nylon_amt_tpu_torch.metrics.multipitch import evaluate_rolls, roll_from_notes
from nylon_amt_tpu_torch.metrics.transcription import evaluate_notes, notes_to_arrays


def score_notes(ref_notes: list[dict], est_notes: list[dict],
                with_velocity: bool = True) -> dict[str, float]:
    """Note-level metric dict for one piece."""
    riv, rp, rv = notes_to_arrays(ref_notes)
    eiv, ep, ev = notes_to_arrays(est_notes)
    return evaluate_notes(riv, rp, eiv, ep,
                          rv if with_velocity else None,
                          ev if with_velocity else None)


def score_frames(ref_notes: list[dict], est_notes: list[dict],
                 fps: float = 62.5, note_min: int = 21,
                 num_note: int = 88) -> dict[str, float]:
    """Frame-level multipitch metric dict for one piece."""
    t_end = max([n["offset"] for n in ref_notes + est_notes] or [0.0])
    n_frames = int(round(t_end * fps)) + 1
    ref_roll = roll_from_notes(ref_notes, n_frames, fps, note_min, num_note)
    est_roll = roll_from_notes(est_notes, n_frames, fps, note_min, num_note)
    return evaluate_rolls(ref_roll, est_roll)


def score_mpe_posteriors(
    ref_notes: list[dict],
    mpe_posteriors: np.ndarray,
    threshold: float = 0.5,
    fps: float = 62.5,
    eval_fps: float = 100.0,
    note_min: int = 21,
    num_note: int = 88,
) -> dict[str, float]:
    """Frame-level metrics of thresholded MPE posteriors vs reference notes.

    The reference's ``m_mpe.py`` path: posteriors (16 ms grid) are
    thresholded, resampled to the 10 ms reference grid by nearest-frame
    lookup (``m_mpe.py:89-125``), and scored with multipitch metrics.
    """
    est_16 = np.asarray(mpe_posteriors) >= threshold       # [T, num_note]
    t_end = max((n["offset"] for n in ref_notes), default=0.0)
    t_end = max(t_end, est_16.shape[0] / fps)
    n_eval = int(round(t_end * eval_fps)) + 1
    # nearest-frame resample of the estimate onto the eval grid
    src = np.clip(np.round(np.arange(n_eval) / eval_fps * fps).astype(int),
                  0, est_16.shape[0] - 1)
    est_roll = est_16[src]
    ref_roll = roll_from_notes(ref_notes, n_eval, eval_fps, note_min, num_note)
    return evaluate_rolls(ref_roll, est_roll)


def aggregate(per_file: dict[str, dict[str, float]]) -> dict[str, float]:
    """Average metric dicts over files (reference corpus mean —
    ``m_transcription.py:125-143``)."""
    if not per_file:
        return {}
    keys = next(iter(per_file.values())).keys()
    return {k: float(np.mean([m[k] for m in per_file.values()])) for k in keys}
