"""Posteriors -> note events: peak-picking decoder.

Rule-for-rule behavioral port of the reference's ``AMT.mpe2note``
(``model/amt.py:179-344``), which directly moves note-level F1:

* **onset/offset detection**: frames at or above threshold that are
  plateau-aware local maxima — ties scan outward until a strictly different
  value decides each side (``:196-213``);
* **sub-frame timing**: neighbor-based linear interpolation around the peak
  (``:214-222``);
* **offset arbitration** per onset: the earliest offset peak after the onset
  (clamped to the next onset), the first frame where the MPE posterior drops
  below threshold, or the next onset, combined by ``mode_offset`` in
  {shorter, longer, offset} (``:258-331``);
* velocity read at the onset frame; ``ignore_zero`` drops velocity-0 notes
  (``:332-336``); overlapping same-pitch notes truncated (``:338-341``).

Implementation note: the reference scans every frame per pitch in Python;
here threshold candidates are found vectorized (posteriors are sparse above
threshold) and only candidates get the plateau scans, which makes decoding
O(active frames) instead of O(frames x 88). Ordering and arithmetic are
identical, verified by tests against the reference source.

Copy of the JAX package's module of the same name: importing that one
would load JAX through its package ``__init__``. A test holds the two
equal.
"""

from __future__ import annotations

import numpy as np


def _detect_peaks(col: np.ndarray, threshold: float, hop_sec: float):
    """Plateau-aware local maxima of one pitch's posterior column.

    Returns list of ``(loc, time)`` with sub-frame interpolated times.
    """
    n = len(col)
    out = []
    for i in np.flatnonzero(col >= threshold):
        v = col[i]
        left = True
        for ii in range(i - 1, -1, -1):
            if v > col[ii]:
                break
            if v < col[ii]:
                left = False
                break
        if not left:
            continue
        right = True
        for ii in range(i + 1, n):
            if v > col[ii]:
                break
            if v < col[ii]:
                right = False
                break
        if not right:
            continue
        if i == 0 or i == n - 1 or col[i - 1] == col[i + 1]:
            t = i * hop_sec
        elif col[i - 1] > col[i + 1]:
            t = i * hop_sec - hop_sec * 0.5 * (col[i - 1] - col[i + 1]) / (v - col[i + 1])
        else:
            t = i * hop_sec + hop_sec * 0.5 * (col[i + 1] - col[i - 1]) / (v - col[i - 1])
        out.append((int(i), float(t)))
    return out


def mpe2note(
    config,
    a_onset: np.ndarray,
    a_offset: np.ndarray,
    a_mpe: np.ndarray,
    a_velocity: np.ndarray,
    thred_onset: float = 0.5,
    thred_offset: float = 0.5,
    thred_mpe: float = 0.5,
    mode_velocity: str = "ignore_zero",
    mode_offset: str = "shorter",
    use_native: bool | None = None,
) -> list[dict]:
    """Decode posterior matrices ``[T, num_note]`` into note events.

    Uses the C++ decoder (``native/decoder.cpp``) when available; identical
    rules, interpreter-free inner loop. ``use_native=False`` forces Python.
    """
    if hasattr(config, "midi"):
        note_min = config.midi.note_min
        num_note = config.midi.num_note
        hop_sec = config.feature.hop_sec
    else:
        note_min = config["midi"]["note_min"]
        num_note = config["midi"]["num_note"]
        hop_sec = float(config["feature"]["hop_sample"] / config["feature"]["sr"])

    a_onset = np.asarray(a_onset)
    a_offset = np.asarray(a_offset)
    a_mpe = np.asarray(a_mpe)
    a_velocity = np.asarray(a_velocity)
    T = a_mpe.shape[0]

    if use_native is not False:
        notes = _mpe2note_native(
            a_onset, a_offset, a_mpe, a_velocity, thred_onset, thred_offset,
            thred_mpe, mode_velocity, mode_offset, hop_sec, note_min)
        if notes is not None:
            return notes
        if use_native:
            raise RuntimeError("native decoder requested but unavailable")

    notes: list[dict] = []
    for j in range(num_note):
        onsets = _detect_peaks(a_onset[:, j], thred_onset, hop_sec)
        offsets = _detect_peaks(a_offset[:, j], thred_offset, hop_sec)
        off_locs = np.array([o[0] for o in offsets], dtype=np.int64)
        # mpe-below-threshold frames for this pitch (vectorized).
        mpe_low = a_mpe[:, j] < thred_mpe

        time_offset = 0.0  # persists across onsets, as in the reference
        for idx_on, (loc_onset, time_onset) in enumerate(onsets):
            if idx_on + 1 < len(onsets):
                loc_next, time_next = onsets[idx_on + 1]
            else:
                loc_next = T
                time_next = (loc_next - 1) * hop_sec

            # first offset peak strictly after the onset
            loc_offset = loc_onset + 1
            flag_offset = False
            k = np.searchsorted(off_locs, loc_onset, side="right")
            if k < len(offsets):
                loc_offset, time_offset = offsets[k]
                flag_offset = True
            if loc_offset > loc_next:
                loc_offset = loc_next
                time_offset = time_next

            # first frame in (onset, next) where mpe < threshold
            # (the reference's "1 frame longer" variant — amt.py:286-295)
            flag_mpe = False
            loc_mpe = loc_onset + 1
            time_mpe = 0.0
            seg = np.flatnonzero(mpe_low[loc_onset + 1 : loc_next])
            if seg.size:
                loc_mpe = loc_onset + 1 + int(seg[0])
                flag_mpe = True
                time_mpe = loc_mpe * hop_sec

            if not flag_offset and not flag_mpe:
                offset_value = float(time_next)
            elif flag_offset and not flag_mpe:
                offset_value = float(time_offset)
            elif not flag_offset and flag_mpe:
                offset_value = float(time_mpe)
            elif mode_offset == "offset":
                offset_value = float(time_offset)
            elif mode_offset == "longer":
                offset_value = float(time_offset if loc_offset >= loc_mpe
                                     else time_mpe)
            else:  # shorter (default)
                offset_value = float(time_offset if loc_offset <= loc_mpe
                                     else time_mpe)

            velocity_value = int(a_velocity[loc_onset, j])
            if mode_velocity == "ignore_zero" and velocity_value <= 0:
                continue
            notes.append({"pitch": int(j + note_min),
                          "onset": float(time_onset),
                          "offset": offset_value,
                          "velocity": velocity_value})
            # truncate overlapping same-pitch predecessor (amt.py:338-341)
            if (len(notes) > 1
                    and notes[-1]["pitch"] == notes[-2]["pitch"]
                    and notes[-1]["onset"] < notes[-2]["offset"]):
                notes[-2]["offset"] = notes[-1]["onset"]

    return sorted(sorted(notes, key=lambda x: x["pitch"]),
                  key=lambda x: x["onset"])


_MODE_OFFSET = {"shorter": 0, "longer": 1, "offset": 2}


def _mpe2note_native(a_onset, a_offset, a_mpe, a_velocity, thred_onset,
                     thred_offset, thred_mpe, mode_velocity, mode_offset,
                     hop_sec, note_min) -> list[dict] | None:
    """ctypes bridge to native/decoder.cpp; None when lib unavailable."""
    import ctypes

    from nylon_amt_tpu.native import load_decoder_library

    lib = load_decoder_library()
    if lib is None:
        return None
    onset = np.ascontiguousarray(a_onset, dtype=np.float32)
    offset = np.ascontiguousarray(a_offset, dtype=np.float32)
    mpe = np.ascontiguousarray(a_mpe, dtype=np.float32)
    velocity = np.ascontiguousarray(a_velocity, dtype=np.int8)
    T, P = mpe.shape

    cap = max(1024, int((onset >= thred_onset).sum()) + 16)
    while True:
        out_pitch = np.empty(cap, np.int32)
        out_onset = np.empty(cap, np.float64)
        out_offset = np.empty(cap, np.float64)
        out_vel = np.empty(cap, np.int32)
        n = lib.nylon_decode_notes(
            onset.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offset.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mpe.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            velocity.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            T, P, thred_onset, thred_offset, thred_mpe,
            _MODE_OFFSET[mode_offset],
            1 if mode_velocity == "ignore_zero" else 0,
            hop_sec, note_min, cap,
            out_pitch.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out_onset.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_offset.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_vel.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if n >= 0:
            break
        cap = -n * 2
    notes = [{"pitch": int(out_pitch[i]), "onset": float(out_onset[i]),
              "offset": float(out_offset[i]), "velocity": int(out_vel[i])}
             for i in range(n)]
    return sorted(sorted(notes, key=lambda x: x["pitch"]),
                  key=lambda x: x["onset"])
