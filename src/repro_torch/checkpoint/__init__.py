"""Atomic checkpointing with async writes and resume, and the GGML Q8_0
export."""
