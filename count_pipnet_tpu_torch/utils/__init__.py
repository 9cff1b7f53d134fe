"""Run logging and checkpoints of the port."""
