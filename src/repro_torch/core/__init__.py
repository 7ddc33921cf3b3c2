"""Core numerics of the port: graphs, multipliers, Chebyshev recurrences
and the exact oracles (mirrors ``repro/core``)."""
