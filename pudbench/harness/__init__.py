"""The yardstick: cells, traffic, the closed-loop driver, the trace
reader, the counts and peaks, and the comparison that decides
``correct``."""
