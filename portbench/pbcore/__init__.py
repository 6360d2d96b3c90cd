"""The benchmark harness of the port: cell discovery from BENCHMARK.json,
seeded inputs, the system under test or the control in its place, one run
of a cell, the trace reduction and the check."""
