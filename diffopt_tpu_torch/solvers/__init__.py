"""Embedded solvers and their diagnostics."""
