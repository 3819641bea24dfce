"""Packet modem framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
gr4-packet-modem reference (GNU Radio 4.0 packet QPSK modem): batched DSP
kernels over time-blocks and packet batches instead of a per-item dataflow
scheduler. See SURVEY.md for the layer map this build follows.
"""

__version__ = "0.1.0"
