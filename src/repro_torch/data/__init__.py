"""The deterministic, host-sharded token pipeline (the port of
`repro/data/`, numpy only)."""
