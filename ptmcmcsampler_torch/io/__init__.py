"""Chain files and checkpoints."""
