"""stablelm-1.6b [dense]: MHA (kv == heads).

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
)
