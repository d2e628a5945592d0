"""Weight loading for inference."""
