"""Optimizers: AdamW with its schedule, clipping and int8 gradient
compression."""
