"""The fault-tolerant training driver (the port of `repro/runtime/`)."""
