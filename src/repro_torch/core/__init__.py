"""Host-side energy, cost and forecast constants (numpy)."""
