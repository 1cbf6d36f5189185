"""Attention schedules; so far only the dense single-device oracle."""
