"""Multi-device batch split (``mesh.py``)."""
