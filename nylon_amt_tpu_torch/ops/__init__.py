"""Compute ops: log-mel frontend, layer kernels, resampling."""
