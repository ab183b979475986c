"""Measurements of the port on the card (``skew_bench``)."""
