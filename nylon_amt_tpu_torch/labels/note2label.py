"""Note events -> frame-aligned training targets.

The port's copy of ``nylon_amt_tpu/labels/note2label.py`` (numpy only,
the same code).

Behavioral port of the reference rasterizer
(``hftt_code/corpus/conv_note2label.py:8-111``) at 62.5 fps (hop 256 @ 16 kHz):

* **Soft onset/offset ramps**: triangular, peaking at 1.0 on the quantized
  frame and decaying linearly to 0 over the +-50 ms tolerance (3 frames),
  max-accumulated across notes (``:54-70,86-97``).
* Optional **offset duration tolerance**: the offset ramp widens to
  ``max(3, round(0.2 * duration / hop))`` frames (``:46-48``).
* **MPE piano roll**: 1 on frames ``[onset_frame, offset_frame]`` inclusive
  (``:72-74``).
* **Velocity**: written where the accumulated onset ramp is >= 0.5. The
  reference's exact (order-dependent) update rule is preserved: frames at or
  after the quantized onset overwrite unconditionally; frames before it only
  fill zeros (``:59-61,69-70``).
* The offset ramp is **suppressed** when another note of the same pitch
  starts exactly (float-equal) at this note's offset (``:77-83``).

Deliberate divergence: notes whose pitch falls outside
[note_min, note_max] are skipped with a warning. The reference would index
the label matrix with a negative pitch and silently corrupt the top rows.
"""

from __future__ import annotations

import warnings

import numpy as np


def note2label(
    config,
    notes: list[dict],
    offset_duration_tolerance_flag: bool = False,
    nframe: int | None = None,
    strings: bool = False,
) -> dict[str, np.ndarray]:
    """Rasterize note events into the four label matrices.

    Returns ``{'mpe': bool [nframe, 88], 'onset': f32, 'offset': f32,
    'velocity': int8}``.

    ``strings=True`` adds a ``'string'`` int8 matrix for the tablature head
    (no reference analog — ModelConfig.tab_head): the note's 1-based string
    index written at the same cells as velocity (0 = no string); notes
    without a ``"string"`` key contribute 0.
    """
    if hasattr(config, "midi"):
        note_min, note_max = config.midi.note_min, config.midi.note_max
        num_note = config.midi.num_note
        hop, sr = config.feature.hop_sample, config.feature.sr
    else:
        note_min = config["midi"]["note_min"]
        note_max = config["midi"]["note_max"]
        num_note = config["midi"]["num_note"]
        hop, sr = config["feature"]["hop_sample"], config["feature"]["sr"]

    hop_ms = 1000.0 * hop / sr
    fps = sr / hop
    tolerance = int(50.0 / hop_ms + 0.5)  # 3 frames at 16 ms hop

    max_offset = max((n["offset"] for n in notes), default=0.0)
    if nframe is None:
        nframe = int(max_offset * fps + 0.5) + 1

    a_mpe = np.zeros((nframe, num_note), dtype=bool)
    a_onset = np.zeros((nframe, num_note), dtype=np.float32)
    a_offset = np.zeros((nframe, num_note), dtype=np.float32)
    a_velocity = np.zeros((nframe, num_note), dtype=np.int8)
    a_string = np.zeros((nframe, num_note), dtype=np.int8) if strings else None

    # Same-pitch onset-time lookup for the offset-suppression rule (replaces
    # the reference's O(n^2) scan; float-equality semantics preserved).
    onsets_by_pitch: dict[int, set] = {}
    for n in notes:
        onsets_by_pitch.setdefault(n["pitch"], set()).add(n["onset"])

    j_all = np.arange(-tolerance, tolerance + 1)

    def ramp(center_frame: int, t_ms: float, sharpness: int, offsets: np.ndarray):
        """Triangular values at ``center_frame + offsets``."""
        frame_ms = (center_frame + offsets) * hop_ms
        return np.maximum(0.0, 1.0 - np.abs(frame_ms - t_ms) / (sharpness * hop_ms))

    for note in notes:
        pitch = note["pitch"] - note_min
        if not (0 <= pitch < num_note):
            warnings.warn(
                f"skipping note with out-of-range pitch {note['pitch']}",
                stacklevel=2,
            )
            continue

        onset_frame = int(note["onset"] * fps + 0.5)
        offset_frame = int(note["offset"] * fps + 0.5)
        onset_ms = note["onset"] * 1000.0
        offset_ms = note["offset"] * 1000.0

        # -- onset ramp + velocity (order-dependent; see module docstring) --
        vals = ramp(onset_frame, onset_ms, tolerance, j_all).astype(np.float32)
        frames = onset_frame + j_all
        valid = (frames >= 0) & (frames < nframe)
        right = j_all >= 0
        string = int(note.get("string", 0)) if strings else 0
        # Right side first (matches reference ordering :54-61).
        for f, v in zip(frames[valid & right], vals[valid & right]):
            a_onset[f, pitch] = max(a_onset[f, pitch], v)
            if a_onset[f, pitch] >= 0.5:
                a_velocity[f, pitch] = note["velocity"]
                if strings:
                    a_string[f, pitch] = string
        for f, v in zip(frames[valid & ~right], vals[valid & ~right]):
            a_onset[f, pitch] = max(a_onset[f, pitch], v)
            if a_onset[f, pitch] >= 0.5 and a_velocity[f, pitch] == 0:
                a_velocity[f, pitch] = note["velocity"]
                if strings:
                    a_string[f, pitch] = string

        # -- mpe roll ------------------------------------------------------
        lo = max(0, onset_frame)
        hi = min(nframe - 1, offset_frame)
        if hi >= lo:
            a_mpe[lo : hi + 1, pitch] = True

        # -- offset ramp ---------------------------------------------------
        if note["offset"] in onsets_by_pitch.get(note["pitch"], ()):  # suppressed
            continue
        off_sharp = tolerance
        if offset_duration_tolerance_flag:
            dur_tol = int((offset_ms - onset_ms) * 0.2 / hop_ms + 0.5)
            off_sharp = max(tolerance, dur_tol)
        j_off = np.arange(-off_sharp, off_sharp + 1)
        vals = ramp(offset_frame, offset_ms, off_sharp, j_off).astype(np.float32)
        frames = offset_frame + j_off
        valid = (frames >= 0) & (frames < nframe)
        f, v = frames[valid], vals[valid]
        np.maximum.at(a_offset[:, pitch], f, v)

    out = {"mpe": a_mpe, "onset": a_onset, "offset": a_offset,
           "velocity": a_velocity}
    if strings:
        out["string"] = a_string
    return out
