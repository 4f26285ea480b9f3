"""Guitar tablature export (alphaTex) — the reference repo's end goal.

The port's copy of ``nylon_amt_tpu/infer/tab.py`` (imports aside,
the same code).

``nylon-amt``'s README declares the long-term goal of transcribing classical
guitar to sheet music / tablature with Alphatab for visualization
(reference ``README.md:27-37``). This module turns decoded note events into

* string/fret assignments for a configurable tuning (standard classical
  EADGBE by default), chosen greedily per time-slice to minimize fret span
  and respect one-note-per-string; and
* an **alphaTex** document (Alphatab's text input format), bar-quantized at a
  fixed tempo, ready for the Alphatab web renderer.

Notes outside the instrument's range are clamped to the nearest playable
octave (flagged in the return value).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# MIDI pitches of open strings, high-to-low (alphaTex numbers strings 1..6
# from the highest string).
STANDARD_TUNING = (64, 59, 55, 50, 45, 40)  # E4 B3 G3 D3 A2 E2


@dataclass
class TabNote:
    onset: float
    duration: float
    string: int          # 1-based, 1 = highest
    fret: int
    pitch: int
    clamped: bool = False


@dataclass
class TabResult:
    notes: list[TabNote] = field(default_factory=list)
    n_clamped: int = 0


def annotate_strings(notes: list[dict], string_grid, config,
                     aggregate: bool = True) -> list[dict]:
    """Attach the tab head's predicted string to decoded note events.

    ``string_grid [T, num_note] int`` is the argmax of the model's
    ``string_B`` logits (``Transcriber.transcript()["string_B"]`` —
    ModelConfig.tab_head). With ``aggregate=True`` (default) each note's
    string is the MAJORITY VOTE of the non-zero grid cells over the note's
    own [onset, offset) span on its pitch row — the per-frame head is noisy
    away from the attack, and a single-cell read (the old behavior,
    ``aggregate=False``) measurably under-performs the vote. A note with no
    non-zero cell in its span stays unannotated, falling back to
    :func:`assign_strings`' greedy rule. Returns new note dicts; the inputs
    are not mutated.
    """
    import numpy as np

    fps = config.feature.frames_per_sec
    note_min = config.midi.note_min
    grid = np.asarray(string_grid)
    T = grid.shape[0]
    out = []
    for n in notes:
        n = dict(n)
        f0 = min(max(int(n["onset"] * fps + 0.5), 0), T - 1)
        if aggregate:
            f1 = min(max(int(n["offset"] * fps + 0.5), f0 + 1), T)
            span = grid[f0:f1, n["pitch"] - note_min]
            votes = np.bincount(span[span > 0].astype(np.int64))
            pred = int(votes.argmax()) if votes.size > 1 else 0
        else:
            pred = int(grid[f0, n["pitch"] - note_min])
        if pred > 0:
            n["string"] = pred
        out.append(n)
    return out


def assign_strings(
    notes: list[dict],
    tuning: tuple[int, ...] = STANDARD_TUNING,
    max_fret: int = 19,
    chord_window: float = 0.03,
) -> TabResult:
    """Assign (string, fret) to note events.

    Notes within ``chord_window`` seconds are treated as one chord; strings
    are allocated to the chord top-down (highest pitch gets the highest
    feasible string), greedily minimizing frets.

    A note carrying a ``"string"`` key (the tab head's prediction — see
    :func:`annotate_strings`) keeps it whenever it is playable (fret in
    range, string free within the chord); infeasible or missing predictions
    fall back to the greedy rule.
    """
    result = TabResult()
    events = sorted(notes, key=lambda n: (n["onset"], -n["pitch"]))
    i = 0
    lo = min(tuning)
    hi = max(tuning) + max_fret
    while i < len(events):
        j = i
        while j < len(events) and \
                events[j]["onset"] - events[i]["onset"] <= chord_window:
            j += 1
        chord = events[i:j]
        used: set[int] = set()
        for n in sorted(chord, key=lambda n: -n["pitch"]):
            pitch = n["pitch"]
            clamped = False
            while pitch < lo:
                pitch += 12
                clamped = True
            while pitch > hi:
                pitch -= 12
                clamped = True
            best = None
            pred = n.get("string")
            if (isinstance(pred, int) and 1 <= pred <= len(tuning)
                    and pred not in used
                    and 0 <= pitch - tuning[pred - 1] <= max_fret):
                best = (pred, pitch - tuning[pred - 1])
            if best is None:
                for s, open_pitch in enumerate(tuning, start=1):
                    if s in used:
                        continue
                    fret = pitch - open_pitch
                    if 0 <= fret <= max_fret:
                        if best is None or fret < best[1]:
                            best = (s, fret)
            if best is None:  # all strings busy: drop to any free string
                for s, open_pitch in enumerate(tuning, start=1):
                    if s not in used and 0 <= pitch - open_pitch:
                        best = (s, min(pitch - open_pitch, max_fret))
                        clamped = True
                        break
            if best is None:
                continue
            used.add(best[0])
            result.notes.append(TabNote(
                onset=n["onset"], duration=max(1e-3, n["offset"] - n["onset"]),
                string=best[0], fret=best[1], pitch=n["pitch"],
                clamped=clamped))
            result.n_clamped += int(clamped)
        i = j
    result.notes.sort(key=lambda t: (t.onset, t.string))
    return result


_DURATIONS = (1, 2, 4, 8, 16, 32)  # whole .. thirty-second


def _quantize_duration(beats: float) -> int:
    """Nearest alphaTex duration denominator for a length in beats."""
    best, best_err = 8, float("inf")
    for d in _DURATIONS:
        err = abs(beats - 4.0 / d)
        if err < best_err:
            best, best_err = d, err
    return best


def to_alphatex(
    notes: list[dict],
    title: str = "nylon-amt transcription",
    tempo: int = 120,
    tuning: tuple[int, ...] = STANDARD_TUNING,
    grid: int = 16,
) -> str:
    """Note events -> alphaTex source (16th-note grid, 4/4).

    Simultaneous notes become chords ``(f.s f.s)``; gaps become rests. This
    is a pragmatic renderer-oriented export, not engraving-quality rhythm
    transcription.
    """
    tab = assign_strings(notes, tuning)
    beat_sec = 60.0 / tempo
    step = beat_sec * 4.0 / grid                     # one grid slot
    slots: dict[int, list[TabNote]] = {}
    for t in tab.notes:
        slots.setdefault(int(round(t.onset / step)), []).append(t)

    lines = [f'\\title "{title}"', f"\\tempo {tempo}", ".",
             "\\ts 4 4"]
    if not slots:
        return "\n".join(lines + ["r.1 |"]) + "\n"

    max_slot = max(slots)
    bar: list[str] = []
    out_bars: list[str] = []
    slot = 0
    while slot <= max_slot:
        if slot in slots:
            group = slots[slot]
            dur = _quantize_duration(
                max(min(t.duration for t in group) / beat_sec, 4.0 / grid))
            if len(group) == 1:
                t = group[0]
                bar.append(f"{t.fret}.{t.string}.{dur}")
            else:
                inner = " ".join(f"{t.fret}.{t.string}" for t in group)
                bar.append(f"({inner}).{dur}")
        else:
            bar.append(f"r.{grid}")
        slot += 1
        if slot % grid == 0:
            out_bars.append(" ".join(bar))
            bar = []
    if bar:
        out_bars.append(" ".join(bar))
    lines.append(" |\n".join(out_bars) + " |")
    return "\n".join(lines) + "\n"


def write_alphatex(notes: list[dict], path: str, **kwargs) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(to_alphatex(notes, **kwargs))
