"""MIDI -> note events -> frame-aligned training targets (the port's copy
of ``nylon_amt_tpu/labels``)."""

from nylon_amt_tpu_torch.labels.midi2note import midi2note
from nylon_amt_tpu_torch.labels.note2label import note2label

__all__ = ["midi2note", "note2label"]
