"""The benchmark's yardstick: traffic, weights, timing, profiles, rooflines and
the comparison that decides ``correct``. The measured package is imported by
the modules that build and drive it (``program.py``, ``entries.py`` and the
``*_cell.py`` runners), never by ``benchmark/reference/``."""
