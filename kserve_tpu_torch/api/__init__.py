"""Clients of the Kubernetes API (api/http_transport.py)."""
