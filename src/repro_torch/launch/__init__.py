"""Launchers of the language-model stack on one device: `serve` (the
continuous-batching engine) and `train` (the fault-tolerant training
loop), and `roofline` (the H100's roofline terms and the analytic
parameter and FLOP counts that bound a step)."""
