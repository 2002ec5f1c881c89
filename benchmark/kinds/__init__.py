"""Loops of the traffic kinds, one module each, found by the kind's name."""
