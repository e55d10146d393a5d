"""Reference-equivalent NumPy baselines (counterpart of
``gccnmf_tpu/baselines``).

``numpy_ref`` is an independent NumPy statement of the reference
algorithm's semantics, quirks included: the golden model the port's tests
and benchmark hold the port against.
"""
