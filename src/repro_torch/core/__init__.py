"""Core-specialization estimator (copy of ``repro.core.adaptive``)."""
