"""Text encoder and generator modules (NCHW inside)."""
