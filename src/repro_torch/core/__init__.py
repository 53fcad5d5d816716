"""Shell core of the port; this slice carries only the MMU service."""
