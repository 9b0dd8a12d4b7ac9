"""Corpus generators (the reference's seeds, the reference's tokens)."""
