from repro_torch.core.passes.pipeline import LADDER, Settings, build_pipeline, optimize, preset

__all__ = ["Settings", "build_pipeline", "optimize", "preset", "LADDER"]
