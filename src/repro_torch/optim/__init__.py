"""Optimizers: AdamW with clipping, its schedule and int8 error feedback
(``adamw``)."""
