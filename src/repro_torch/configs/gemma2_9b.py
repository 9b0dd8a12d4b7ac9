"""gemma2-9b: 42L d3584 16H (GQA kv=8, head 256) d_ff 14336, vocab 256000,
alternating local(4096)/global attention, attn softcap 50, final softcap 30,
post-block norms.  [arXiv:2408.00118]"""
import torch

from repro_torch.configs.lm_common import LMArch, smoke_lm
from repro_torch.models import transformer as T

FULL = T.LMConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=14336, vocab=256000,
    pattern=("local", "global"), use_rope_pattern=(True, True),
    window=4096, attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    dtype=torch.bfloat16)

# sequence-parallel TP: the residual stream's S split over 'model' (the
# reference's rules)
ARCH = LMArch("gemma2-9b", FULL, smoke_lm("gemma2-9b", FULL), long_ok=True,
              extra_rules=(("seq", "model"),))
