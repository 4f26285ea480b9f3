"""Utilities: audio IO."""
