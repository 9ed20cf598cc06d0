"""One module per configuration, found by the configuration's name.

Each module builds the program's line for its configuration from the
coefficients that :func:`design` draws from the seed, and computes the same
chain with :mod:`portbench.reference`. Its sizes live in the JSON file of the
same name.
"""
