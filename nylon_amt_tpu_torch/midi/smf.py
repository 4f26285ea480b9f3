"""Standard MIDI File parsing and writing (no external dependencies).

A copy of ``nylon_amt_tpu/midi/smf.py`` (the port imports nothing of the
JAX package); ``write_notes`` writes the same bytes as the original.

Supports everything the AMT pipeline needs from real-world piano MIDI
(MAESTRO / MAPS): format 0/1 files, running status, note on/off, control
changes (sustain pedal CC64), set_tempo meta events, and multi-track layouts.
Unknown events are parsed and skipped while preserving delta-time accounting.

Writing emits a two-track format-1 file (tempo track + note track) with a
fixed tempo, equivalent in content to the reference's pretty_midi emission
(``model/amt.py:347-355``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterable

# Event kinds surfaced to consumers. Everything else becomes "other".
NOTE_ON = "note_on"
NOTE_OFF = "note_off"
CONTROL_CHANGE = "control_change"
SET_TEMPO = "set_tempo"
END_OF_TRACK = "end_of_track"
OTHER = "other"

DEFAULT_TEMPO = 500000  # microseconds per beat (120 BPM)


@dataclass
class MidiEvent:
    """One event with its absolute time in ticks."""

    tick: int
    kind: str
    channel: int = 0
    note: int = 0
    velocity: int = 0
    control: int = 0
    value: int = 0
    tempo: int = 0


@dataclass
class MidiTrack:
    events: list[MidiEvent] = field(default_factory=list)

    @property
    def total_ticks(self) -> int:
        return self.events[-1].tick if self.events else 0


@dataclass
class MidiFile:
    ticks_per_beat: int = 480
    tracks: list[MidiTrack] = field(default_factory=list)

    # ---- reading ---------------------------------------------------------

    @classmethod
    def read(cls, path: str) -> "MidiFile":
        with open(path, "rb") as f:
            return cls._parse(f)

    @classmethod
    def _parse(cls, f: BinaryIO) -> "MidiFile":
        magic, length = _read_chunk_header(f)
        if magic != b"MThd":
            raise ValueError(f"not a MIDI file (header chunk {magic!r})")
        header = f.read(length)
        if len(header) < 6:
            raise ValueError("truncated MThd chunk")
        fmt, ntrks, division = struct.unpack(">HHH", header[:6])
        if division & 0x8000:
            raise ValueError("SMPTE time division is not supported")
        mf = cls(ticks_per_beat=division, tracks=[])
        for _ in range(ntrks):
            magic, length = _read_chunk_header(f)
            data = f.read(length)
            if magic != b"MTrk":
                continue  # skip alien chunks per the SMF spec
            mf.tracks.append(_parse_track(data))
        return mf

    # ---- writing ---------------------------------------------------------

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            fmt = 1 if len(self.tracks) > 1 else 0
            f.write(b"MThd" + struct.pack(">IHHH", 6, fmt, len(self.tracks),
                                          self.ticks_per_beat))
            for track in self.tracks:
                f.write(_encode_track(track))


def _read_chunk_header(f: BinaryIO) -> tuple[bytes, int]:
    head = f.read(8)
    if len(head) < 8:
        raise ValueError("truncated MIDI chunk header")
    return head[:4], struct.unpack(">I", head[4:])[0]


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def _encode_varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


_CHANNEL_DATA_LEN = {0x8: 2, 0x9: 2, 0xA: 2, 0xB: 2, 0xC: 1, 0xD: 1, 0xE: 2}


def _parse_track(data: bytes) -> MidiTrack:
    events: list[MidiEvent] = []
    pos = 0
    tick = 0
    running_status = None
    n = len(data)
    while pos < n:
        delta, pos = _read_varlen(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            if running_status is None:
                raise ValueError("data byte with no running status")
            status = running_status

        if status == 0xFF:  # meta event
            meta_type = data[pos]
            length, pos = _read_varlen(data, pos + 1)
            payload = data[pos : pos + length]
            pos += length
            if meta_type == 0x51 and length == 3:
                tempo = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                events.append(MidiEvent(tick, SET_TEMPO, tempo=tempo))
            elif meta_type == 0x2F:
                events.append(MidiEvent(tick, END_OF_TRACK))
                break
            else:
                events.append(MidiEvent(tick, OTHER))
            running_status = None  # meta/sysex clears running status
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varlen(data, pos)
            pos += length
            events.append(MidiEvent(tick, OTHER))
            running_status = None
        else:  # channel message
            hi, channel = status >> 4, status & 0x0F
            nbytes = _CHANNEL_DATA_LEN[hi]
            d = data[pos : pos + nbytes]
            pos += nbytes
            if hi == 0x9:
                events.append(MidiEvent(tick, NOTE_ON, channel=channel,
                                        note=d[0], velocity=d[1]))
            elif hi == 0x8:
                events.append(MidiEvent(tick, NOTE_OFF, channel=channel,
                                        note=d[0], velocity=d[1]))
            elif hi == 0xB:
                events.append(MidiEvent(tick, CONTROL_CHANGE, channel=channel,
                                        control=d[0], value=d[1]))
            else:
                events.append(MidiEvent(tick, OTHER, channel=channel))
    return MidiTrack(events=events)


def _encode_track(track: MidiTrack) -> bytes:
    chunks: list[bytes] = []
    prev_tick = 0
    has_eot = False
    for ev in track.events:
        delta = ev.tick - prev_tick
        if delta < 0:
            raise ValueError("track events must be sorted by tick")
        prev_tick = ev.tick
        chunks.append(_encode_varlen(delta))
        if ev.kind == NOTE_ON:
            chunks.append(bytes((0x90 | ev.channel, ev.note, ev.velocity)))
        elif ev.kind == NOTE_OFF:
            chunks.append(bytes((0x80 | ev.channel, ev.note, ev.velocity)))
        elif ev.kind == CONTROL_CHANGE:
            chunks.append(bytes((0xB0 | ev.channel, ev.control, ev.value)))
        elif ev.kind == SET_TEMPO:
            chunks.append(bytes((0xFF, 0x51, 0x03,
                                 (ev.tempo >> 16) & 0xFF,
                                 (ev.tempo >> 8) & 0xFF,
                                 ev.tempo & 0xFF)))
        elif ev.kind == END_OF_TRACK:
            chunks.append(bytes((0xFF, 0x2F, 0x00)))
            has_eot = True
        else:
            raise ValueError(f"cannot encode event kind {ev.kind!r}")
    if not has_eot:
        chunks.append(_encode_varlen(0) + bytes((0xFF, 0x2F, 0x00)))
    body = b"".join(chunks)
    return b"MTrk" + struct.pack(">I", len(body)) + body


def write_notes(
    path: str,
    notes: Iterable[dict],
    ticks_per_beat: int = 480,
    tempo: int = DEFAULT_TEMPO,
    channel: int = 0,
) -> None:
    """Write note events (``{'pitch','onset','offset','velocity'}`` in
    seconds) to a MIDI file.

    Content-equivalent to the reference's ``AMT.note2midi``
    (``model/amt.py:347-355``): one instrument track, program 0.
    """
    sec_per_tick = tempo / 1e6 / ticks_per_beat

    def to_tick(sec: float) -> int:
        return max(0, int(round(sec / sec_per_tick)))

    tempo_track = MidiTrack([MidiEvent(0, SET_TEMPO, tempo=tempo)])
    events: list[MidiEvent] = []
    for note in notes:
        on, off = to_tick(note["onset"]), to_tick(note["offset"])
        if off <= on:
            off = on + 1
        events.append(MidiEvent(on, NOTE_ON, channel=channel,
                                note=int(note["pitch"]),
                                velocity=int(note["velocity"])))
        events.append(MidiEvent(off, NOTE_OFF, channel=channel,
                                note=int(note["pitch"]), velocity=0))
    # Stable sort; note_offs before note_ons at equal ticks so retriggered
    # pitches close before reopening.
    events.sort(key=lambda e: (e.tick, 0 if e.kind == NOTE_OFF else 1))
    MidiFile(ticks_per_beat=ticks_per_beat,
             tracks=[tempo_track, MidiTrack(events)]).write(path)
