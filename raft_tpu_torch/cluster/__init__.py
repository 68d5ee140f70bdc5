"""Balanced k-means (the IVF coarse quantizer)."""
