"""Host-side data helpers (numpy)."""
