"""Host-side data: the stateless counter -> batch pipelines (``pipeline``)
and the GNN neighbour sampler (``graph_sampler``)."""
