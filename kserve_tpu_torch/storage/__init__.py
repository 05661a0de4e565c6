"""Model artifact storage (storage.py) and the storage-initializer entry
point (initializer.py)."""
