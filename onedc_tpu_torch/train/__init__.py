"""Stage-I training: losses, optimizer and step, trainer."""
