"""Reliability layer: only the numpy-only sampled-parity checkwords the FTL
records at write time are ported so far (ROADMAP queue 1 item 7)."""
