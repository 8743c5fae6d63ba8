"""Models of the port (``gan.py``) and the building blocks they use (``layers.py``)."""
