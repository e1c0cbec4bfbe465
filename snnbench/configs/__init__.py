"""Frozen NumPy copies of the networks' generators (the benchmark's own
inputs): ``<generator>.py`` turns a configuration's JSON into a graph."""
