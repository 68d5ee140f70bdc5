"""Distance metric types."""
