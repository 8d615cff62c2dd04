"""The port's roofline (counterpart of the JAX ``repro.roofline``), in an
H100's terms: ``kernels`` (the work of one launch of each hand-written
kernel, and the counter the kernels report to), ``collectives`` (the
collectives a step ran, by the ring rules), ``analysis`` (the three-term
bound and MFU at it) and ``report`` (the tables from the dry-run's
records)."""
