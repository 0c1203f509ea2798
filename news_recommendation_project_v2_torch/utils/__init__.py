"""Host-side utilities: the in-flight dispatch window and batch sizing."""
