"""Launchers (PyTorch port of :mod:`repro.launch`): mesh descriptors and
the train / serve drivers."""
