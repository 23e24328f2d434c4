"""The dense decoder-only model of the port."""
