"""Serving over the port's plan cache: `query_server.QueryServer`
(coalescing windows, in-flight compile dedup, admission, deadlines,
retry, the degradation ladder, tiered serving), `admission` (its
controller, typed errors and telemetry) and `chaos` (the seeded fault
harness); `batcher` is the language models' continuous-batching
engine."""
