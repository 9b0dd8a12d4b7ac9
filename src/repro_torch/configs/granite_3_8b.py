"""granite-3-8b: 40L d4096 32H (GQA kv=8, head 128) d_ff 12800.
True vocab 49155 is padded to 49408 (= 193*256), as in the reference, whose
vocab dim must divide its model axis (16); labels never touch the pad rows.
[hf:ibm-granite]"""
import torch

from repro_torch.configs.lm_common import LMArch, smoke_lm
from repro_torch.models import transformer as T

FULL = T.LMConfig(
    name="granite-3-8b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12800, vocab=49408,        # padded from 49155
    dtype=torch.bfloat16)

# sequence-parallel TP: the residual stream's S split over 'model' (the
# reference's rules)
ARCH = LMArch("granite-3-8b", FULL, smoke_lm("granite-3-8b", FULL),
              long_ok=False,
              extra_rules=(("seq", "model"),))
