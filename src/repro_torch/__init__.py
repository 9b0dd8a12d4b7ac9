"""repro_torch — the PyTorch/CUDA port of the WTBC ranked-retrieval system.

Slice 1 answers WTBC-DR tf-idf ``and``/``or`` searches on one NVIDIA H100:
the host builds the index (numpy), the search cores run as PyTorch tensor
code, and the two kernels of the path — the fused wavelet-tree count descent
and the mega core's search loop — are hand-written CUDA C++ (``csrc/``).
Entry points run on the card unless the caller asks for the CPU, where every
kernel runs its plain PyTorch version.

    from repro_torch.engine import SearchEngine
    engine = SearchEngine.build(doc_tokens)              # device="cuda"
    results = engine.search(queries, k=10, mode="or")
"""
