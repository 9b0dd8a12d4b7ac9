"""xdeepfm [arXiv:1803.05170]: 39 sparse features, embed 10,
CIN layers 200-200-200 + DNN 400-400 + linear, 1M-bucket hashing."""
from repro_torch.configs.recsys_common import RecsysArch
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(name="xdeepfm", interaction="cin", n_sparse=39,
                    embed_dim=10, table_rows=(1_000_000,) * 39,
                    cin_layers=(200, 200, 200))
SMOKE = RecsysConfig(name="xdeepfm-smoke", interaction="cin", n_sparse=6,
                     embed_dim=10, table_rows=(1000,) * 6, cin_layers=(16, 16))
ARCH = RecsysArch("xdeepfm", FULL, SMOKE)
