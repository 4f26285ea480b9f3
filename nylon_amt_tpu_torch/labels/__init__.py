"""MIDI -> note events (the port's copy of ``nylon_amt_tpu/labels``;
``note2label`` comes with ``cli corpus``)."""

from nylon_amt_tpu_torch.labels.midi2note import midi2note

__all__ = ["midi2note"]
