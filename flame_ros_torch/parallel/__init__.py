"""Batched execution: many streams on one device (multi_stream)."""
