"""Nearest-neighbour indexes: IVF-PQ, refine, brute-force ground truth."""
