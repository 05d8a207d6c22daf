"""The language-model stack: the ten model families of `configs/`,
prefill, decode and the differentiable forward, on one device or over a
mesh (`sharding`; the port of `repro/models/`; the serving engine is
`repro_torch.serve.batcher`, the training step `repro_torch.train`)."""
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.sharding import Ctx
from repro_torch.models.transformer import (LM, cache_struct, cast_params,
                                            decode_step, forward_train,
                                            init_cache, pad_cache, prefill)
from repro_torch.models.weights import (from_reference, init_params,
                                        to_reference,
                                        train_state_from_reference,
                                        train_state_to_reference)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "Ctx", "LM",
           "init_params", "from_reference", "to_reference", "cast_params",
           "forward_train", "prefill", "decode_step", "cache_struct",
           "init_cache", "pad_cache", "train_state_from_reference",
           "train_state_to_reference"]
