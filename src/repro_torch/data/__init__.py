"""Data pipeline: the synthetic TinyStories-like stream, packing,
sharding."""
