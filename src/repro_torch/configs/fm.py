"""fm: Factorization Machine [Rendle ICDM'10] — 39 sparse features, embed 10,
pairwise interactions via the O(nk) sum-square trick.  Criteo-style 1M-bucket
hashing per feature."""
from repro_torch.configs.recsys_common import RecsysArch
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(name="fm", interaction="fm", n_sparse=39, embed_dim=10,
                    table_rows=(1_000_000,) * 39)
SMOKE = RecsysConfig(name="fm-smoke", interaction="fm", n_sparse=6,
                     embed_dim=10, table_rows=(1000,) * 6)
ARCH = RecsysArch("fm", FULL, SMOKE)
