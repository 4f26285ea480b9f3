"""Self-contained Standard MIDI File (SMF) reader/writer (the port's copy
of ``nylon_amt_tpu/midi``)."""

from nylon_amt_tpu_torch.midi.smf import MidiEvent, MidiFile, MidiTrack, write_notes

__all__ = ["MidiEvent", "MidiFile", "MidiTrack", "write_notes"]
