"""Note-level transcription metrics (mir_eval.transcription semantics).

The port's copy of ``nylon_amt_tpu/metrics/transcription.py`` (imports aside,
the same code).

The reference scores with ``mir_eval.transcription.evaluate`` and
``mir_eval.transcription_velocity.evaluate``
(``evaluation/m_transcription.py:110-123``); mir_eval is not available in
this environment, so the algorithms are reimplemented here from their
published definitions (Raffel et al., "mir_eval: A Transparent
Implementation of Common MIR Metrics", ISMIR 2014; velocity criterion from
Hawthorne et al., "Onsets and Frames", ISMIR 2018):

* a reference and an estimated note match when onsets are within
  ``onset_tolerance`` (50 ms), pitches within ``pitch_tolerance`` (50 cents),
  and — for the with-offset variant — offsets within
  ``max(offset_min_tolerance, offset_ratio * ref_duration)``;
* matching is **maximum-cardinality bipartite matching** over the candidate
  graph (one ref note matches at most one estimate), computed with scipy's
  Hopcroft-Karp;
* Precision = matched/|est|, Recall = matched/|ref|, F = harmonic mean;
  Average_Overlap_Ratio = mean over matched pairs of
  ``(min(offsets) - max(onsets)) / (max(offsets) - min(onsets))``;
* the velocity variant rescales estimated velocities onto the references by
  least squares over the timing-matched pairs, normalizes by the maximum
  matched reference velocity, then RE-MATCHES over the candidate graph with
  the velocity criterion (tolerance 0.1) as an additional edge condition —
  see :func:`match_notes_velocity`.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching


def note_to_hz(midi_pitch) -> np.ndarray:
    """MIDI pitch -> Hz (reference ``conv_note2ref.py:6-7``)."""
    return 440.0 * (2.0 ** ((np.asarray(midi_pitch, dtype=np.float64) - 69) / 12))


def _candidate_matrix(
    ref_intervals, ref_pitches, est_intervals, est_pitches,
    onset_tolerance, pitch_tolerance, offset_ratio, offset_min_tolerance,
) -> np.ndarray:
    """Boolean [n_ref, n_est] candidate-match matrix."""
    n_ref, n_est = len(ref_pitches), len(est_pitches)
    if n_ref == 0 or n_est == 0:
        return np.zeros((n_ref, n_est), dtype=bool)
    onset_ok = (np.abs(ref_intervals[:, None, 0] - est_intervals[None, :, 0])
                <= onset_tolerance)
    cents = 1200.0 * np.abs(np.log2(est_pitches[None, :] / ref_pitches[:, None]))
    pitch_ok = cents <= pitch_tolerance
    ok = onset_ok & pitch_ok
    if offset_ratio is not None:
        durations = ref_intervals[:, 1] - ref_intervals[:, 0]
        tol = np.maximum(offset_min_tolerance, offset_ratio * durations)
        offset_ok = (np.abs(ref_intervals[:, None, 1] - est_intervals[None, :, 1])
                     <= tol[:, None])
        ok &= offset_ok
    return ok


def _max_matching(ok: np.ndarray) -> list[tuple[int, int]]:
    """Maximum-cardinality bipartite matching pairs (ref_idx, est_idx)."""
    if not ok.any():
        return []
    perm = maximum_bipartite_matching(csr_matrix(ok), perm_type="column")
    return [(i, int(j)) for i, j in enumerate(perm) if j >= 0]


def match_notes(
    ref_intervals, ref_pitches, est_intervals, est_pitches,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: float | None = 0.2,
    offset_min_tolerance: float = 0.05,
) -> list[tuple[int, int]]:
    ref_intervals = np.atleast_2d(np.asarray(ref_intervals, dtype=np.float64))
    est_intervals = np.atleast_2d(np.asarray(est_intervals, dtype=np.float64))
    ref_pitches = np.asarray(ref_pitches, dtype=np.float64)
    est_pitches = np.asarray(est_pitches, dtype=np.float64)
    ok = _candidate_matrix(ref_intervals, ref_pitches, est_intervals,
                           est_pitches, onset_tolerance, pitch_tolerance,
                           offset_ratio, offset_min_tolerance)
    return _max_matching(ok)


def _prf(n_match: int, n_est: int, n_ref: int) -> tuple[float, float, float]:
    precision = n_match / n_est if n_est else 0.0
    recall = n_match / n_ref if n_ref else 0.0
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return precision, recall, f


def _overlap_ratio(ref_intervals, est_intervals, matching) -> float:
    if not matching:
        return 0.0
    ratios = []
    for i, j in matching:
        overlap = min(ref_intervals[i, 1], est_intervals[j, 1]) - \
            max(ref_intervals[i, 0], est_intervals[j, 0])
        union = max(ref_intervals[i, 1], est_intervals[j, 1]) - \
            min(ref_intervals[i, 0], est_intervals[j, 0])
        ratios.append(overlap / union if union > 0 else 0.0)
    return float(np.mean(ratios))


def match_notes_velocity(
    ref_intervals, ref_pitches, ref_velocities, est_intervals, est_pitches,
    est_velocities,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: float | None = 0.2,
    offset_min_tolerance: float = 0.05,
    velocity_tolerance: float = 0.1,
) -> list[tuple[int, int]]:
    """Velocity-aware matching (``mir_eval.transcription_velocity`` semantics,
    used by the reference at ``m_transcription.py:119-123``).

    The velocity criterion is folded into the matching itself: (1) a plain
    onset/pitch/offset matching determines a least-squares affine rescaling
    of the estimated velocities onto the references; (2) both sides are
    normalized by the maximum matched reference velocity; (3) the candidate
    graph is rebuilt with the additional constraint that the rescaled
    velocity difference is within ``velocity_tolerance``; (4) a second
    maximum bipartite matching runs over that graph. A post-hoc filter of
    step (1)'s matching would undercount — a velocity-rejected pair can block
    a valid alternative pairing that the re-match recovers.
    """
    ref_intervals = np.atleast_2d(np.asarray(ref_intervals, dtype=np.float64))
    est_intervals = np.atleast_2d(np.asarray(est_intervals, dtype=np.float64))
    ref_pitches = np.asarray(ref_pitches, dtype=np.float64)
    est_pitches = np.asarray(est_pitches, dtype=np.float64)
    ref_velocities = np.asarray(ref_velocities, dtype=np.float64)
    est_velocities = np.asarray(est_velocities, dtype=np.float64)

    ok = _candidate_matrix(ref_intervals, ref_pitches, est_intervals,
                           est_pitches, onset_tolerance, pitch_tolerance,
                           offset_ratio, offset_min_tolerance)
    base = _max_matching(ok)
    if not base:
        return []
    rv = ref_velocities[[i for i, _ in base]]
    ev = est_velocities[[j for _, j in base]]
    # least-squares affine est -> ref over the timing-matched pairs
    A = np.vstack([ev, np.ones_like(ev)]).T
    (slope, intercept), *_ = np.linalg.lstsq(A, rv, rcond=None)
    est_scaled = slope * est_velocities + intercept
    norm = rv.max()
    if norm > 0:
        ref_n = ref_velocities / norm
        est_n = est_scaled / norm
    else:
        ref_n, est_n = ref_velocities, est_scaled
    vel_ok = (np.abs(ref_n[:, None] - est_n[None, :]) <= velocity_tolerance)
    return _max_matching(ok & vel_ok)


def evaluate_notes(
    ref_intervals, ref_pitches, est_intervals, est_pitches,
    ref_velocities=None, est_velocities=None,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: float = 0.2,
    offset_min_tolerance: float = 0.05,
) -> dict[str, float]:
    """Full metric dict (the fields the reference consumes:
    ``m_transcription.py:110-143``)."""
    ref_intervals = np.atleast_2d(np.asarray(ref_intervals, dtype=np.float64))
    est_intervals = np.atleast_2d(np.asarray(est_intervals, dtype=np.float64))
    ref_pitches = np.asarray(ref_pitches, dtype=np.float64)
    est_pitches = np.asarray(est_pitches, dtype=np.float64)
    n_ref, n_est = len(ref_pitches), len(est_pitches)

    m_off = match_notes(ref_intervals, ref_pitches, est_intervals, est_pitches,
                        onset_tolerance, pitch_tolerance, offset_ratio,
                        offset_min_tolerance)
    m_noff = match_notes(ref_intervals, ref_pitches, est_intervals,
                         est_pitches, onset_tolerance, pitch_tolerance,
                         offset_ratio=None)

    p, r, f = _prf(len(m_off), n_est, n_ref)
    pn, rn, fn = _prf(len(m_noff), n_est, n_ref)
    out = {
        "Precision": p, "Recall": r, "F-measure": f,
        "Average_Overlap_Ratio": _overlap_ratio(ref_intervals, est_intervals,
                                                m_off),
        "Precision_no_offset": pn, "Recall_no_offset": rn,
        "F-measure_no_offset": fn,
        "Average_Overlap_Ratio_no_offset": _overlap_ratio(
            ref_intervals, est_intervals, m_noff),
    }
    if ref_velocities is not None and est_velocities is not None:
        mv = match_notes_velocity(
            ref_intervals, ref_pitches, ref_velocities, est_intervals,
            est_pitches, est_velocities, onset_tolerance, pitch_tolerance,
            offset_ratio, offset_min_tolerance)
        pv, rv_, fv = _prf(len(mv), n_est, n_ref)
        out.update({"Precision_velocity": pv, "Recall_velocity": rv_,
                    "F-measure_velocity": fv})
    return out


def notes_to_arrays(notes: list[dict]):
    """Note dicts -> (intervals, pitches_hz, velocities) arrays."""
    if not notes:
        return (np.zeros((0, 2)), np.zeros((0,)), np.zeros((0,)))
    intervals = np.array([[n["onset"], n["offset"]] for n in notes],
                         dtype=np.float64)
    pitches = note_to_hz([n["pitch"] for n in notes])
    velocities = np.array([n["velocity"] for n in notes], dtype=np.float64)
    return intervals, pitches, velocities
