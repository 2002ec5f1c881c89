"""Host utilities of the port: tracing (spans and counters) and the seed
helper, and the PLY export."""
