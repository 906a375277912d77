"""Distribution helpers of the port (one card: gradient compression)."""
