"""Fault-tolerance runtime: heartbeats, stragglers, elastic replanning."""
