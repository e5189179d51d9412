"""Helpers of the port's training path (dataclasses, operations, seeding)."""
