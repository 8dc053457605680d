"""The card's calibration probes (counterparts of the Pallas probes in ``tools/``)."""
