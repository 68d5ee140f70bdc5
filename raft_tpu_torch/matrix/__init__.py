"""Top-k selection."""
