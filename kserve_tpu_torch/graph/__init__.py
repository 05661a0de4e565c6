"""The InferenceGraph router (graph/router.py)."""
