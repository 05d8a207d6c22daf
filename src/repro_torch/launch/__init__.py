"""Launchers of the language-model stack: `serve` (the continuous-batching
engine on one device)."""
