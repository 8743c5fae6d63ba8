"""Utilities of the port: the weight bridge (``weights.py``)."""
