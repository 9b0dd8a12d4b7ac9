"""llama4-scout-17b-16e: 48L d5120 40H (GQA kv=8, head 128) d_ff 8192,
vocab 202048, MoE 16 experts top-1 + 1 shared; iRoPE attention — 3 of 4
layers chunked-local (8192), 1 of 4 global with NoPE.  [hf:meta-llama]

Decode of a chunked layer keeps a ring of ``min(window, max_len)`` slots and,
once it is full, attends to the last ``window`` positions (a sliding window),
while the forward pass attends within the aligned chunk: past a chunk
boundary the two disagree.  That is the reference's behaviour, kept as it
is (ROADMAP Queue 3, R9)."""
import torch

from repro_torch.configs.lm_common import LMArch, smoke_lm
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEConfig

FULL = T.LMConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048, rope_theta=5e5,
    pattern=("chunked", "chunked", "chunked", "global"),
    use_rope_pattern=(True, True, True, False),
    window=8192,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1),
    dtype=torch.bfloat16)

# 40 heads do not divide model=16, so heads replicate; sequence-parallel TP
# as the other LMs (the reference's rules)
ARCH = LMArch("llama4-scout-17b-a16e", FULL,
              smoke_lm("llama4-scout-17b-a16e", FULL),
              long_ok=True,
              extra_rules=(("heads", None), ("seq", "model")))
