"""Rich synthetic proof corpus: MIDI (with pedal/re-onsets/tempo) -> audio.

The port's copy of ``scripts/proof_corpus.py`` (numpy only, the same code)
on the port's ``midi/smf.py`` and ``labels/midi2note.py``.

The round-4 proof corpus saturated the measuring instrument: one sparse
monophonic held-out piece scored 1.0 on every metric, and the hardest label
paths (CC64 sustain, same-pitch re-onsets — reference
``conv_midi2note.py:78-135``) were never exercised end to end. This
generator produces pieces that exercise them all, THROUGH the real
pipeline: it composes note/pedal/tempo events, writes a standard MIDI file
(``midi/smf.py``), parses it back with ``labels/midi2note.py`` (so the
ground truth is exactly what the corpus pipeline computes, sustain-extended
offsets and re-onset closures included), and synthesizes audio from the
parsed notes.

Per piece:
* chords (2-4 simultaneous pitches) and overlapping voices;
* same-pitch re-onsets — both rapid repeats and re-onsets of
  pedal-sustained notes;
* CC64 sustain spans covering ~40% of the piece (notes ring to the pedal
  release);
* a mid-piece tempo change (exercises the TempoCurve path);
* velocities spread over [25, 120] with velocity-dependent amplitude and
  brightness (so velocity is in principle audible).
"""

from __future__ import annotations

import numpy as np

from nylon_amt_tpu_torch.midi import smf
from nylon_amt_tpu_torch.midi.smf import MidiEvent, MidiFile, MidiTrack

TPB = 480


class _TempoMap:
    """seconds -> ticks for a two-segment tempo curve."""

    def __init__(self, tempo1: int, tempo2: int, t_change: float):
        self.tempo1, self.tempo2, self.t_change = tempo1, tempo2, t_change
        self.tick_change = round(t_change * 1e6 / tempo1 * TPB)

    def tick(self, sec: float) -> int:
        if sec <= self.t_change:
            return round(sec * 1e6 / self.tempo1 * TPB)
        return self.tick_change + round(
            (sec - self.t_change) * 1e6 / self.tempo2 * TPB)


def compose(rng: np.random.Generator, dur: float = 20.0,
            pitch_lo: int = 40, pitch_hi: int = 90):
    """Compose (note_events, pedal_spans, tempo_map).

    note_events: (onset_sec, dur_sec, pitch, velocity) BEFORE sustain; the
    sounding truth comes from midi2note on the written file.
    """
    tempo1 = int(rng.integers(400_000, 650_000))
    tempo2 = int(rng.integers(400_000, 650_000))
    tmap = _TempoMap(tempo1, tempo2, t_change=dur * float(rng.uniform(.4, .6)))

    # Density calibration (r5): the first cut of this generator reached
    # max polyphony ~13 under long pedal spans — unlearnable for the
    # hid-64 proof recipe at proof-corpus scale (held-out F1 0.14). The
    # rates below keep every hard LABEL path (pedal-extended offsets,
    # re-onsets incl. re-onset-under-pedal, chords, tempo change) while
    # holding polyphony to ~3-6 so the proof model can climb to a
    # non-degenerate but sub-1.0 score band.
    events = []
    t = 0.15
    while t < dur - 1.2:
        kind = rng.random()
        if kind < 0.28:                      # chord, 2-3 notes
            root = int(rng.integers(pitch_lo, pitch_hi - 13))
            n = int(rng.integers(2, 4))
            ivals = rng.choice([4, 5, 7, 12], size=n - 1, replace=False)
            pitches = [root] + [root + int(np.sum(ivals[:k + 1]))
                                for k in range(n - 1)]
            length = float(rng.uniform(0.25, 0.8))
            for p in pitches:
                events.append((t, length * float(rng.uniform(0.85, 1.0)), p,
                               int(rng.integers(25, 121))))
            t += float(rng.uniform(0.4, 0.9))
        elif kind < 0.5:                     # rapid same-pitch repeats
            p = int(rng.integers(pitch_lo, pitch_hi))
            n_rep = int(rng.integers(2, 4))
            step = float(rng.uniform(0.15, 0.3))
            for k in range(n_rep):
                # duration >= step: the next onset CLOSES the previous note
                # (the re-onset path), both with and without pedal
                events.append((t + k * step, step * float(rng.uniform(1.0, 1.5)),
                               p, int(rng.integers(25, 121))))
            t += n_rep * step + float(rng.uniform(0.15, 0.4))
        else:                                # melody note (may overlap)
            p = int(rng.integers(pitch_lo, pitch_hi))
            events.append((t, float(rng.uniform(0.1, 0.6)), p,
                           int(rng.integers(25, 121))))
            t += float(rng.uniform(0.15, 0.45))

    # short pedal spans over ~20% of the piece (never overlapping)
    spans = []
    t = float(rng.uniform(0.5, 2.0))
    while t < dur - 1.5:
        span = float(rng.uniform(0.5, 1.2))
        if rng.random() < 0.45:
            spans.append((t, min(t + span, dur - 0.6)))
        t += span + float(rng.uniform(1.0, 2.2))
    return events, spans, tmap


def write_midi(path: str, events, pedal_spans, tmap: _TempoMap,
               dur: float) -> None:
    tempo_track = MidiTrack(events=[
        MidiEvent(tick=0, kind=smf.SET_TEMPO, tempo=tmap.tempo1),
        MidiEvent(tick=tmap.tick_change, kind=smf.SET_TEMPO,
                  tempo=tmap.tempo2),
    ])
    evs = []
    for (on, length, pitch, vel) in events:
        off = min(on + length, dur - 0.05)
        evs.append((tmap.tick(on), 1, MidiEvent(
            tick=tmap.tick(on), kind=smf.NOTE_ON, note=pitch, velocity=vel)))
        evs.append((tmap.tick(off), 0, MidiEvent(
            tick=tmap.tick(off), kind=smf.NOTE_OFF, note=pitch)))
    for (lo, hi) in pedal_spans:
        evs.append((tmap.tick(lo), 2, MidiEvent(
            tick=tmap.tick(lo), kind=smf.CONTROL_CHANGE, control=64,
            value=100)))
        evs.append((tmap.tick(hi), 0, MidiEvent(
            tick=tmap.tick(hi), kind=smf.CONTROL_CHANGE, control=64,
            value=0)))
    # offs/releases before ons at equal ticks (0 < 1): a repeat whose
    # note_off coincides with the next onset stays a clean re-onset
    evs.sort(key=lambda e: (e[0], e[1]))
    MidiFile(ticks_per_beat=TPB,
             tracks=[tempo_track,
                     MidiTrack(events=[e for _, _, e in evs])]).write(path)


def synth_from_notes(notes, sr: int = 16000, dur: float = 20.0,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """Additive decaying-harmonic synthesis of the PARSED (sustain-extended)
    notes: the audio rings exactly as long as the label says."""
    rng = rng or np.random.default_rng(0)
    t_all = np.arange(int(dur * sr)) / sr
    wav = np.zeros_like(t_all)
    for n in notes:
        on, off = n["onset"], min(n["offset"], dur)
        if off <= on:
            continue
        f0 = 440.0 * 2 ** ((n["pitch"] - 69) / 12)
        seg = (t_all >= on) & (t_all < off)
        t = t_all[seg] - on
        v = n["velocity"] / 127.0
        # velocity controls level AND brightness; slow decay + release ramp
        amp = (0.08 + 0.30 * v) * np.exp(-t * 2.2)
        rel = np.minimum(1.0, (off - on - t) / 0.03)
        tone = np.sin(2 * np.pi * f0 * t)
        tone += (0.25 + 0.35 * v) * np.sin(4 * np.pi * f0 * t)
        tone += (0.08 + 0.22 * v) * np.sin(6 * np.pi * f0 * t)
        wav[seg] += amp * rel * tone
    wav += 0.002 * rng.standard_normal(wav.shape)
    peak = np.max(np.abs(wav))
    if peak > 1.0:
        wav = wav / peak
    return np.clip(wav, -1, 1).astype(np.float32)


def synth_rich_piece(rng: np.random.Generator, config, midi_path: str,
                    sr: int = 16000, dur: float = 20.0):
    """Compose -> write SMF -> parse with midi2note -> synthesize.

    Returns ``(wav float32 [dur*sr], notes)`` where ``notes`` is exactly
    ``labels.midi2note(config, midi_path)`` (the pipeline ground truth).
    """
    from nylon_amt_tpu_torch.labels import midi2note

    events, spans, tmap = compose(rng, dur=dur)
    write_midi(midi_path, events, spans, tmap, dur)
    notes = midi2note(config, midi_path)
    wav = synth_from_notes(notes, sr=sr, dur=dur, rng=rng)
    return wav, notes
