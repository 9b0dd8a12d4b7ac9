"""repro_torch — the PyTorch/CUDA port of the WTBC ranked-retrieval system.

It answers WTBC-DR and WTBC-DRB ``and``/``or`` searches (tf-idf and BM25)
and ``phrase``/``near`` searches on one NVIDIA H100, and serves them
(``repro_torch.serve``: snapshots, micro-batching, cache, load generation;
``repro_torch.obs``: metrics and request spans).  The host builds the index
(numpy), the search cores run as PyTorch tensor code, and every kernel of
their paths is hand-written CUDA C++ (``csrc/``).  Entry points run on the
card unless the caller asks for the CPU, where every kernel runs its plain
PyTorch version.

    from repro_torch.engine import SearchEngine
    engine = SearchEngine.build(doc_tokens)              # device="cuda"
    results = engine.search(queries, k=10, mode="or")
"""
