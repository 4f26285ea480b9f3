"""Sheet-music export (MusicXML) — the other half of the reference's goal.

The port's copy of ``nylon_amt_tpu/infer/sheet.py`` (imports aside,
the same code).

``nylon-amt``'s README declares the long-term goal of transcribing classical
guitar to **sheet music** / tablature (reference ``README.md:27-37``);
``infer/tab.py`` covers the tablature half (alphaTex), this module covers the
notation half: decoded note events -> a minimal, valid **MusicXML 3.1
score-partwise** document that MuseScore / Finale / Alphatab can open.

Same pragmatic model as the alphaTex exporter: onsets quantized to a
16th-note grid at a fixed tempo, simultaneous notes become chords, gaps
become rests. To keep the stream single-voice (and the document trivially
valid), a note sounds until the earliest of its quantized duration, the next
occupied grid slot, or the bar line — engraving-quality rhythm/voice
separation is out of scope, as it is for the reference.
"""

from __future__ import annotations

from xml.sax.saxutils import escape

# Pitch spelling with sharps (guitar/piano default for machine export).
_STEPS = ("C", "C", "D", "D", "E", "F", "F", "G", "G", "A", "A", "B")
_ALTER = (0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 0)

# note-type name per duration denominator (4/denominator beats).
_TYPE = {1: "whole", 2: "half", 4: "quarter", 8: "eighth", 16: "16th",
         32: "32nd"}


def _pitch_xml(midi: int) -> str:
    octave = midi // 12 - 1
    step = _STEPS[midi % 12]
    alter = _ALTER[midi % 12]
    alter_el = f"<alter>{alter}</alter>" if alter else ""
    return (f"<pitch><step>{step}</step>{alter_el}"
            f"<octave>{octave}</octave></pitch>")


def _slot_type(slots: int, grid: int) -> str:
    """Nearest printable note type for a length of ``slots`` grid units."""
    beats = slots * 4.0 / grid
    best, best_err = 16, float("inf")
    for denom, _ in _TYPE.items():
        err = abs(beats - 4.0 / denom)
        if err < best_err:
            best, best_err = denom, err
    return _TYPE[best]


def to_musicxml(
    notes: list[dict],
    title: str = "nylon-amt transcription",
    tempo: int = 120,
    grid: int = 16,
) -> str:
    """Note events (``{pitch, onset, offset, velocity}``) -> MusicXML source.

    ``grid`` slots per 4/4 bar (16 = 16th-note quantization, matching
    ``infer/tab.py::to_alphatex``); ``divisions`` is ``grid/4`` per quarter
    so one grid slot is exactly one duration unit.
    """
    beat_sec = 60.0 / tempo
    step_sec = beat_sec * 4.0 / grid
    divisions = grid // 4

    # slot -> chord (descending pitch for stable chord order)
    slots: dict[int, list[dict]] = {}
    for n in sorted(notes, key=lambda n: (n["onset"], -n["pitch"])):
        slots.setdefault(int(round(n["onset"] / step_sec)), []).append(n)

    n_slots = (max(slots) + 1) if slots else grid
    n_bars = (n_slots + grid - 1) // grid
    occupied = sorted(slots)

    measures: list[str] = []
    for bar in range(n_bars):
        body: list[str] = []
        if bar == 0:
            body.append(
                f"<attributes><divisions>{divisions}</divisions>"
                "<key><fifths>0</fifths></key>"
                "<time><beats>4</beats><beat-type>4</beat-type></time>"
                "<clef><sign>G</sign><line>2</line></clef></attributes>")
            body.append(
                '<direction placement="above"><direction-type>'
                f'<metronome><beat-unit>quarter</beat-unit>'
                f"<per-minute>{tempo}</per-minute></metronome>"
                "</direction-type>"
                f'<sound tempo="{tempo}"/></direction>')
        slot = bar * grid
        bar_end = slot + grid
        while slot < bar_end:
            if slot in slots:
                nxt = next((s for s in occupied if s > slot), None)
                limit = min(bar_end, nxt if nxt is not None else bar_end)
                group = slots[slot]
                want = max(
                    1,
                    int(round(min(n["offset"] - n["onset"] for n in group)
                              / step_sec)))
                dur = max(1, min(want, limit - slot))
                typ = _slot_type(dur, grid)
                for k, n in enumerate(group):
                    chord = "<chord/>" if k else ""
                    body.append(
                        f"<note>{chord}{_pitch_xml(n['pitch'])}"
                        f"<duration>{dur}</duration>"
                        f"<type>{typ}</type></note>")
                slot += dur
            else:
                nxt = next((s for s in occupied if s > slot), None)
                limit = min(bar_end, nxt if nxt is not None else bar_end)
                dur = limit - slot
                typ = _slot_type(dur, grid)
                body.append(f"<note><rest/><duration>{dur}</duration>"
                            f"<type>{typ}</type></note>")
                slot += dur
        measures.append(f'<measure number="{bar + 1}">'
                        + "".join(body) + "</measure>")

    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<!DOCTYPE score-partwise PUBLIC "-//Recordare//DTD MusicXML 3.1 '
        'Partwise//EN" "http://www.musicxml.org/dtds/partwise.dtd">\n'
        '<score-partwise version="3.1">'
        f"<work><work-title>{escape(title)}</work-title></work>"
        "<part-list><score-part id=\"P1\">"
        "<part-name>Guitar</part-name></score-part></part-list>"
        '<part id="P1">' + "".join(measures) + "</part></score-partwise>\n")


def write_musicxml(notes: list[dict], path: str, **kwargs) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(to_musicxml(notes, **kwargs))
