"""WSGI serving."""
