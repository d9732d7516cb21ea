"""Timing and metrics helpers."""
