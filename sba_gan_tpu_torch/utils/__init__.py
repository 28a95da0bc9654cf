"""Image, visualization, device and weight utilities."""
