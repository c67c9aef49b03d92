"""Hybrid stochastic-binary arithmetic and the SC first layer (torch port)."""
