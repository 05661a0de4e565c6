"""The multi-model serving agent (watcher.py)."""
