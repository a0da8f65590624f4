"""Launchers (PyTorch port of :mod:`repro.launch`): mesh descriptors, the
train / serve drivers, and the AOT dry run (``dryrun.py``) with its cost
counter (``cost_analysis.py``) and per-op breakdown (``diagnose.py``)."""
