"""Rodinia benchmark ports on the port's engine."""
