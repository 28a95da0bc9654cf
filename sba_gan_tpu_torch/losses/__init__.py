"""DAMSM losses."""
