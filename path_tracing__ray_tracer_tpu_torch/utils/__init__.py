"""Host-side utilities: logging, timing, image assembly, assets."""
