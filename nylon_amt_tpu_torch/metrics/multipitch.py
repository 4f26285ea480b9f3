"""Frame-level multipitch metrics (mir_eval.multipitch semantics).

The port's copy of ``nylon_amt_tpu/metrics/multipitch.py`` (imports aside,
the same code).

The reference thresholds MPE posteriors into ragged per-frame frequency lists
at a 16 ms grid, resamples to the 10 ms reference grid, and calls
``mir_eval.multipitch.evaluate`` (``evaluation/m_mpe.py:77-158``). Those
metrics are reimplemented here: per frame, estimated and reference
frequencies match within 50 cents (one-to-one, greedy on sorted cents —
frequencies are note-quantized in this pipeline so matching is exact set
intersection in practice); totals give Precision / Recall / Accuracy and the
error decomposition (E_sub / E_miss / E_fa / E_tot, Poliner & Ellis 2007).

``evaluate_rolls`` is the fast TPU-pipeline path operating directly on
aligned boolean piano rolls (identical results for note-quantized data
without the txt round-trip).
"""

from __future__ import annotations

import numpy as np


def _to_cents(freqs: np.ndarray) -> np.ndarray:
    return 1200.0 * np.log2(np.maximum(freqs, 1e-8) / 10.0)


def _frame_counts(ref_freqs: list[np.ndarray], est_freqs: list[np.ndarray],
                  window: float = 50.0):
    """Per-frame TP / n_ref / n_est with 50-cent one-to-one matching."""
    n_tp = n_ref = n_est = 0
    e_sub_n = e_miss_n = e_fa_n = 0
    for rf, ef in zip(ref_freqs, est_freqs):
        rf = np.asarray(rf, dtype=np.float64)
        ef = np.asarray(ef, dtype=np.float64)
        nr, ne = len(rf), len(ef)
        n_ref += nr
        n_est += ne
        if nr and ne:
            rc = np.sort(_to_cents(rf))
            ec = np.sort(_to_cents(ef))
            # one-to-one greedy matching on sorted values
            i = j = tp = 0
            while i < len(rc) and j < len(ec):
                if abs(rc[i] - ec[j]) <= window:
                    tp += 1
                    i += 1
                    j += 1
                elif ec[j] < rc[i]:
                    j += 1
                else:
                    i += 1
        else:
            tp = 0
        n_tp += tp
        # Poliner-Ellis per-frame error counts
        e_sub_n += min(nr, ne) - tp
        e_miss_n += max(0, nr - ne)
        e_fa_n += max(0, ne - nr)
    return n_tp, n_ref, n_est, e_sub_n, e_miss_n, e_fa_n


def evaluate_frames(ref_freqs: list[np.ndarray], est_freqs: list[np.ndarray]
                    ) -> dict[str, float]:
    """Frame lists (same time grid) -> multipitch metric dict."""
    if len(ref_freqs) != len(est_freqs):
        raise ValueError("ref and est must share a time grid")
    tp, n_ref, n_est, es, em, ef = _frame_counts(ref_freqs, est_freqs)
    precision = tp / n_est if n_est else 0.0
    recall = tp / n_ref if n_ref else 0.0
    accuracy = tp / (n_est + n_ref - tp) if (n_est + n_ref - tp) else 0.0
    denom = max(n_ref, 1)
    out = {
        "Precision": precision,
        "Recall": recall,
        "Accuracy": accuracy,
        "Substitution Error": es / denom,
        "Miss Error": em / denom,
        "False Alarm Error": ef / denom,
        "Total Error": (es + em + ef) / denom,
    }
    out["F-measure"] = (2 * precision * recall / (precision + recall)
                        if precision + recall > 0 else 0.0)
    return out


def evaluate_rolls(ref_roll: np.ndarray, est_roll: np.ndarray
                   ) -> dict[str, float]:
    """Aligned boolean piano rolls ``[T, n_note]`` -> same metric dict.

    Equivalent to :func:`evaluate_frames` on note-quantized frequencies, but
    fully vectorized (no ragged lists).
    """
    if ref_roll.shape != est_roll.shape:
        raise ValueError("rolls must be aligned")
    ref = ref_roll.astype(bool)
    est = est_roll.astype(bool)
    tp = int((ref & est).sum())
    n_ref = int(ref.sum())
    n_est = int(est.sum())
    nr = ref.sum(axis=1)
    ne = est.sum(axis=1)
    tpf = (ref & est).sum(axis=1)
    es = int((np.minimum(nr, ne) - tpf).sum())
    em = int(np.maximum(0, nr - ne).sum())
    ef = int(np.maximum(0, ne - nr).sum())

    precision = tp / n_est if n_est else 0.0
    recall = tp / n_ref if n_ref else 0.0
    accuracy = tp / (n_est + n_ref - tp) if (n_est + n_ref - tp) else 0.0
    denom = max(n_ref, 1)
    out = {
        "Precision": precision, "Recall": recall, "Accuracy": accuracy,
        "Substitution Error": es / denom, "Miss Error": em / denom,
        "False Alarm Error": ef / denom, "Total Error": (es + em + ef) / denom,
    }
    out["F-measure"] = (2 * precision * recall / (precision + recall)
                        if precision + recall > 0 else 0.0)
    return out


def roll_from_notes(notes: list[dict], n_frames: int, fps: float,
                    note_min: int, num_note: int) -> np.ndarray:
    """Rasterize note events to a boolean roll (for frame-level eval)."""
    roll = np.zeros((n_frames, num_note), dtype=bool)
    for n in notes:
        p = n["pitch"] - note_min
        if not (0 <= p < num_note):
            continue
        a = int(round(n["onset"] * fps))
        b = int(round(n["offset"] * fps))
        roll[max(0, a) : min(n_frames, b + 1), p] = True
    return roll
