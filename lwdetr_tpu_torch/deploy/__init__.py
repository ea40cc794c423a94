"""Deployment: the exported artifact (`export.py`) and its benchmark (`benchmark.py`)."""
