"""Weight conversion and preprocessing."""
