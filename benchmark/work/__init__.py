"""The benchmark's frozen roofline counts (``roofline``)."""
