"""Optimization helpers: rematerialisation (optimization/remat.py)."""
