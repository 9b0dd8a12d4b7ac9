"""Host-side data: the GNN neighbour sampler (``graph_sampler``)."""
