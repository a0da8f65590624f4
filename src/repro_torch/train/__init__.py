"""Training (PyTorch port of :mod:`repro.train`): step factories and the
fault-tolerant loop."""
