"""Inference: engine, batched transcription, note decoding."""
