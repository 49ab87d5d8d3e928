"""Cross-cutting utilities: metric logging and profiling."""
