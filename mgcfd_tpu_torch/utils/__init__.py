"""Host utilities: gated diagnostic logging."""
