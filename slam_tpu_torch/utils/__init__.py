"""Synthetic scenes and trajectory metrics (numpy)."""
