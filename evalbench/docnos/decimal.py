"""Docnos that are decimal integers below ``below`` (MS MARCO's passage
ids): ``{"style": "decimal", "below": 8841823}``."""

from evalbench.data import decimal_strings


def make(spec):
    """(the number of distinct docnos, a function of ids → docnos)."""
    return int(spec["below"]), decimal_strings
