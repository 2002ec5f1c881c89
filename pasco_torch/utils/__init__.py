"""Host utilities of the port: timing and profiling, and the PLY export."""
