"""Caption handling."""
