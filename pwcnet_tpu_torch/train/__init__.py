"""Inference helpers (training is not ported yet)."""
