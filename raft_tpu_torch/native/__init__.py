"""The port's native host library: C for the PNG row filter and the
augmentation ops, built at first use (``build.py``)."""
