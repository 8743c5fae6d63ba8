"""HTTP serving on the port (``app.py``)."""
