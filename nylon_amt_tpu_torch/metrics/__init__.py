"""Evaluation metrics: mir_eval-equivalent note and frame scoring (the
port's copy of ``nylon_amt_tpu/metrics``)."""

from nylon_amt_tpu_torch.metrics.transcription import (
    evaluate_notes,
    match_notes,
    note_to_hz,
)
from nylon_amt_tpu_torch.metrics.multipitch import evaluate_frames, evaluate_rolls

__all__ = ["evaluate_notes", "match_notes", "note_to_hz",
           "evaluate_frames", "evaluate_rolls"]
