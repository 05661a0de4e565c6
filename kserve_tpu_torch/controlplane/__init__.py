"""The part of the control plane the port has: the Kubernetes kind table
(gvk.py) that api/http_transport.py speaks."""
