"""sasrec [arXiv:1808.09781]: embed 50, 2 self-attention blocks, 1 head,
seq_len 50, next-item training with BCE + 1 sampled negative per position.
Item space 1,000,000 so retrieval_cand scores real candidates (on the card:
one K6 ``scored_topk`` launch over the 10^6 gathered item rows)."""
from repro_torch.configs.recsys_common import RecsysArch
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(name="sasrec", interaction="self-attn-seq", embed_dim=50,
                    seq_len=50, n_blocks=2, n_heads=1, n_items=1_000_000)
SMOKE = RecsysConfig(name="sasrec-smoke", interaction="self-attn-seq",
                     embed_dim=16, seq_len=10, n_blocks=2, n_heads=1,
                     n_items=500)
ARCH = RecsysArch("sasrec", FULL, SMOKE)
