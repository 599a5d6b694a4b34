"""Host utilities: gated diagnostic logging and checkpoints."""
