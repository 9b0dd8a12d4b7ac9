"""The model zoo, as plain PyTorch over parameter dicts in the reference's
layout: layers, attention, MoE and the decoder-only transformer (forward,
prefill, decode); the recsys towers (serve, retrieval, the loss value); and
EGNN (forward, the loss value)."""
