"""Host data helpers (numpy only)."""
