"""qwen3-1.7b: 28L d2048 16H (GQA kv=8, head 128) d_ff 6144, vocab 151936,
qk_norm.  [hf:Qwen/Qwen3 family]"""
import torch

from repro_torch.configs.lm_common import LMArch, smoke_lm
from repro_torch.models import transformer as T

FULL = T.LMConfig(
    name="qwen3-1.7b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1e6,
    dtype=torch.bfloat16)

# sequence-parallel TP: the residual stream's S split over 'model' (the
# reference's rules)
ARCH = LMArch("qwen3-1.7b", FULL, smoke_lm("qwen3-1.7b", FULL), long_ok=False,
              extra_rules=(("seq", "model"),))
