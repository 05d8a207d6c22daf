"""Step-atomic checkpoints with an asynchronous write and a restore onto
any device (the port of `repro/checkpoint/`)."""
