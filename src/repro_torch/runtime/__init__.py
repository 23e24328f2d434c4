"""Runtime health: the serving engine's straggler detector."""
