"""Hand-written Hopper kernels, their plain PyTorch versions and the
builder that compiles them (csrc/)."""
