"""Utilities: step timing and device memory (utils/profiling.py)."""
