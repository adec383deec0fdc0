"""Subpackage of the frozen plain reference."""
