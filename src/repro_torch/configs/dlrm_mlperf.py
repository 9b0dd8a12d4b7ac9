"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM benchmark config (Criteo 1TB):
13 dense + 26 sparse features with the published per-feature cardinalities,
embed 128, bottom MLP 13-512-256-128, dot interaction, top MLP
1024-1024-512-256-1.

A seed-era fixture of the reference (outside the WTBC retrieval stack).  Its
tables hold 187,775,488 rows x 128 float32 (96.1 GB): more than one H100's
80 GB, so a one-card run caps the rows of its largest tables."""
from repro_torch.configs.recsys_common import RecsysArch
from repro_torch.models.recsys import CRITEO_1TB_ROWS, RecsysConfig

FULL = RecsysConfig(name="dlrm-mlperf", interaction="dot", n_sparse=26,
                    n_dense=13, embed_dim=128, table_rows=CRITEO_1TB_ROWS,
                    bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1))
SMOKE = RecsysConfig(name="dlrm-smoke", interaction="dot", n_sparse=5,
                     n_dense=4, embed_dim=8, table_rows=(1000,) * 5,
                     bot_mlp=(16, 8), top_mlp=(16, 8, 1))
ARCH = RecsysArch("dlrm-mlperf", FULL, SMOKE)
