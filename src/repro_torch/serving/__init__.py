"""Paged serving: block allocator, scheduler and engine."""
