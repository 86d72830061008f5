"""Fault tolerance shared by the serving supervisor (and, later, training)."""
