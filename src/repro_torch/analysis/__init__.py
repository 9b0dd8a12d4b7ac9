"""Analytic models attached to measured searches (the WTBC roofline)."""
