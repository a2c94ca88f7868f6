"""Per-layer metric readers, one file each (``spec.load_metric``)."""
