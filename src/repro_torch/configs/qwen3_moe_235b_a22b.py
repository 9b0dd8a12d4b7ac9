"""qwen3-moe-235b-a22b: 94L d4096 64H (GQA kv=4, head 128) expert-ff 1536,
vocab 151936, MoE 128 experts top-8, qk_norm.  [hf:Qwen/Qwen3-30B-A3B family]"""
import torch

from repro_torch.configs.lm_common import LMArch, smoke_lm
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEConfig

FULL = T.LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536,                      # (unused: every layer is MoE)
    vocab=151936, qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536),
    dtype=torch.bfloat16)

ARCH = LMArch("qwen3-moe-235b-a22b", FULL, smoke_lm("qwen3-moe-235b-a22b", FULL),
              long_ok=False)
