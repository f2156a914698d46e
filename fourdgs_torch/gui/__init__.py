"""The live viewer (gui/viewer.py)."""
