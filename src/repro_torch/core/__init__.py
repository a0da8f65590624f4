"""MCFlash core: encodings, the Vth device model, sensing and read planning
(PyTorch port of :mod:`repro.core`)."""
