"""Losses, metrics, optimizers and the trainer with on-card click simulation."""
