"""RULER-style synthetic long-context tasks (``synthetic.py``)."""
