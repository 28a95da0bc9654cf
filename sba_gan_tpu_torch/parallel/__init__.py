"""Data parallelism over ranks (``parallel/dist.py``)."""
