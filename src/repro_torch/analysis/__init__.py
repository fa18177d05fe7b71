"""Calibration artifact loader (copy of ``repro.analysis.derived``)."""
