"""Roofline terms on the H100's constants (port of ``repro.roofline``)."""
