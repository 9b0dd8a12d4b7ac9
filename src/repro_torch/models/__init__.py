"""The model zoo's LM path: layers, attention, MoE and the decoder-only
transformer (forward, prefill, decode), as plain PyTorch over parameter
dicts in the reference's layout."""
