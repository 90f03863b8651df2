"""Pretraining step, optimizer, schedules and loss balancing."""
