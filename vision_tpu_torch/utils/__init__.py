"""Render-state checkpoints and debug utilities (checkpoint.py, debug.py,
visualizer.py)."""
