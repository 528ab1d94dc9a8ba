"""Checkpoint loading and timing helpers."""
