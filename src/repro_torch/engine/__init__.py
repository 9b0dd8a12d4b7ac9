"""repro_torch.engine — the port's ranked-retrieval query facade.

    from repro_torch.engine import SearchEngine
    engine = SearchEngine.build(doc_tokens)          # on the card
    results = engine.search(queries, k=10, mode="and")

See :class:`SearchEngine`, :class:`EngineConfig` and :class:`SearchResults`.
"""
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.facade import (MEASURES, MODES, POSITIONAL_MODES,
                                       STRATEGIES, SearchEngine)
from repro_torch.engine.results import SearchResults

__all__ = ["EngineConfig", "SearchEngine", "SearchResults",
           "MEASURES", "MODES", "POSITIONAL_MODES", "STRATEGIES"]
