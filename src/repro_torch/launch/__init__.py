"""Meshes, step builders, the training driver and the dry-run (port of
``repro.launch``)."""
