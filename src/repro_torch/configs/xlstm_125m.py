"""xLSTM-125M [arXiv:2405.04517]: mLSTM + sLSTM blocks (3:1), d_ff=0 (the
cells carry their own projections).  Recurrent state is O(1) in sequence
length, so all long-context cells run."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50_304,
    pattern=("mlstm", "mlstm", "mlstm", "slstm"), rope="none",
)
SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, vocab=256, dtype="float32")
