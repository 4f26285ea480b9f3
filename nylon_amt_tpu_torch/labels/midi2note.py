"""MIDI file -> note-event list.

The port's copy of ``nylon_amt_tpu/labels/midi2note.py`` (imports aside,
the same code).

Behavioral port of the reference's event-accurate parser
(``hftt_code/corpus/conv_midi2note.py:23-190``), rebuilt on our own SMF
reader. Reproduced semantics:

* **Tempo curve** built from track 0's ``set_tempo`` events; ticks before the
  first tempo event map to time 0 (the reference initializes the running
  tempo to 0 — ``conv_midi2note.py:40-41``). Implemented as piecewise-linear
  segments + vectorized searchsorted instead of the reference's
  O(total_ticks) dense array.
* Note events come from the **last** track (``conv_midi2note.py:72``).
* **Sustain pedal (CC64)**: value >= 64 arms the pedal and marks held keys
  sustained; value < 64 releases — keys no longer pressed but sustained are
  emitted with offset at the release time (``:78-112``).
* **Re-onset**: a note_on for an already-sounding pitch closes the old note
  (offset = new onset) and flags the new one ``reonset`` (``:119-135``).
* ``note_on`` with velocity 0 is note-off (``:143-144``).
* Still-sounding notes at end-of-track are flushed with the final event time
  (``:174-187``); flush covers only pitches in [note_min, note_max].
* Output sorted by (onset, pitch) (``:188``).
"""

from __future__ import annotations

import bisect

from nylon_amt_tpu_torch.midi import smf
from nylon_amt_tpu_torch.midi.smf import MidiFile

NUM_PITCH = 128


class TempoCurve:
    """tick -> seconds, from a track's set_tempo events.

    Matches the reference's dense-array construction
    (``conv_midi2note.py:29-54``) including its initial-tempo-0 convention.
    """

    def __init__(self, mf: MidiFile, track_index: int = 0):
        ticks_per_beat = mf.ticks_per_beat
        boundaries = [0]      # segment start ticks
        times = [0.0]         # seconds at segment start
        tempos = [0]          # microseconds/beat applying from segment start
        tick_prev, time_prev, tempo_prev = 0, 0.0, 0
        track = mf.tracks[track_index] if mf.tracks else None
        for ev in (track.events if track else ()):
            if ev.kind == smf.SET_TEMPO:
                if ev.tick > tick_prev:
                    time_prev += (ev.tick - tick_prev) / ticks_per_beat * tempo_prev / 1e6
                    tick_prev = ev.tick
                    boundaries.append(tick_prev)
                    times.append(time_prev)
                    tempos.append(ev.tempo)
                else:
                    # tempo change at the current boundary: overwrite in place
                    tempos[-1] = ev.tempo
                tempo_prev = ev.tempo
        self._ticks_per_beat = ticks_per_beat
        self._boundaries = boundaries
        self._times = times
        self._tempos = tempos

    def seconds(self, tick: int) -> float:
        i = bisect.bisect_right(self._boundaries, tick) - 1
        dt = tick - self._boundaries[i]
        return self._times[i] + dt / self._ticks_per_beat * self._tempos[i] / 1e6


def midi2note(config, f_midi: str, verbose_flag: bool = False) -> list[dict]:
    """Parse a MIDI file into sorted note-event dicts.

    ``config`` follows the reference's dict shape (``config['midi']``) or our
    :class:`~nylon_amt_tpu_torch.config.Config`.
    """
    if hasattr(config, "midi"):
        note_min, note_max = config.midi.note_min, config.midi.note_max
    else:
        note_min = config["midi"]["note_min"]
        note_max = config["midi"]["note_max"]

    mf = MidiFile.read(f_midi)
    tempo = TempoCurve(mf, track_index=0)

    onset = [-1.0] * NUM_PITCH
    velocity = [-1] * NUM_PITCH
    reonset = [False] * NUM_PITCH
    pushed = [False] * NUM_PITCH
    sustained = [False] * NUM_PITCH

    notes: list[dict] = []
    pedal_on = False
    time_in_sec = 0.0

    def emit(pitch: int, offset_sec: float) -> None:
        notes.append({
            "onset": onset[pitch],
            "offset": offset_sec,
            "pitch": pitch,
            "velocity": velocity[pitch],
            "reonset": reonset[pitch],
        })

    for ev in mf.tracks[-1].events:
        time_in_sec = tempo.seconds(ev.tick)
        if ev.kind == smf.CONTROL_CHANGE and ev.control == 64:
            if ev.value < 64:  # pedal release
                for p in range(note_min, note_max + 1):
                    if not pushed[p] and sustained[p]:
                        emit(p, time_in_sec)
                        onset[p], velocity[p], reonset[p] = -1.0, -1, False
                pedal_on = False
                for p in range(note_min, note_max + 1):
                    sustained[p] = False
            else:  # pedal press
                pedal_on = True
                for p in range(note_min, note_max + 1):
                    if pushed[p]:
                        sustained[p] = True
        elif ev.kind == smf.NOTE_ON and ev.velocity > 0:
            p = ev.note
            if pushed[p] or sustained[p]:
                emit(p, time_in_sec)     # close sounding note at the re-onset
                reonset[p] = True
            else:
                reonset[p] = False
            onset[p] = time_in_sec
            velocity[p] = ev.velocity
            pushed[p] = True
            if pedal_on:
                sustained[p] = True
        elif ev.kind == smf.NOTE_OFF or (ev.kind == smf.NOTE_ON and ev.velocity == 0):
            p = ev.note
            if pushed[p] and not sustained[p]:
                emit(p, time_in_sec)
                onset[p], velocity[p], reonset[p] = -1.0, -1, False
            pushed[p] = False

    for p in range(note_min, note_max + 1):
        if pushed[p] or sustained[p]:
            emit(p, time_in_sec)

    # (onset, pitch) ordering via two stable sorts, as in the reference.
    return sorted(sorted(notes, key=lambda x: x["pitch"]), key=lambda x: x["onset"])
