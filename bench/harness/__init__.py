"""The benchmark's harness: cells, traffic, drivers, traces, the check."""
